"""The device prefetcher on the card: pinned host memory, the copy on a
side stream, the consumer's stream waiting on the copy, `record_stream`.

Imports nothing of JAX, so that it runs on a machine with a card and no
JAX: `python -m pytest --noconftest -m cuda tests/test_torch_prefetch_cuda.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.data.prefetch import DevicePrefetcher  # noqa: E402

BATCHES = 300


def _source(i):
    rng = np.random.default_rng(i)
    return {"image": rng.integers(0, 256, (4, 96, 96, 3), dtype=np.uint8),
            "boxes": rng.uniform(0, 96, (4, 20, 4)).astype(np.float32),
            "image_id": i}


@pytest.mark.cuda
def test_slow_consumer_reads_what_the_host_sent():
    """The consumer's stream is kept busy before it reads each batch, and
    nothing is synchronised until the end: a batch whose memory the
    allocator handed to a later copy too early, or a read that did not
    wait for its copy, gives a wrong checksum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the side-stream copy has no CPU mode")
    counter = iter(range(BATCHES))
    sums = []
    with DevicePrefetcher(lambda: _source(next(counter)), depth=3,
                          device="cuda", keys=("image", "boxes")) as pf:
        for i, batch in enumerate(pf):
            assert batch["image_id"] == i
            assert batch["image"].is_cuda and batch["boxes"].is_cuda
            torch.cuda._sleep(200_000)  # a slow step on the consumer stream
            sums.append((batch["image"].to(torch.int64).sum(),
                         batch["boxes"].to(torch.float64).sum()))
            del batch
    torch.cuda.synchronize()
    assert len(sums) == BATCHES
    for i, (image_sum, box_sum) in enumerate(sums):
        src = _source(i)
        assert image_sum.item() == int(src["image"].astype(np.int64).sum()), i
        assert box_sum.item() == pytest.approx(
            float(src["boxes"].astype(np.float64).sum()), rel=1e-12), i


@pytest.mark.cuda
def test_batch_equals_source_while_the_producer_runs_ahead():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the side-stream copy has no CPU mode")
    counter = iter(range(50))
    with DevicePrefetcher(lambda: _source(next(counter)), depth=2,
                          device="cuda", keys=("image",)) as pf:
        for i, batch in enumerate(pf):
            torch.cuda._sleep(1_000_000)
            got = batch["image"].cpu().numpy()
            np.testing.assert_array_equal(got, _source(i)["image"])
    assert i == 49
