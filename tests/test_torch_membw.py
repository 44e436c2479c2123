"""The bandwidth probe's reduction on the CPU: the wrapper takes the plain
version for a CPU tensor, and the plain version equals float64 sums of the
bf16 values to rtol 1e-5 (float32 accumulation over a few thousand rows).
The Triton kernel itself runs on the card only (`chip_smoke.py`)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.tools import membw_experiments as probe  # noqa: E402


@pytest.mark.parametrize("rows", [1, 64, 1000, 4096])
def test_channel_stats_on_cpu_is_the_plain_version(rows):
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.normal(0.5, 2.0, (rows, probe.LANES))
                         .astype(np.float32)).to(torch.bfloat16)
    before = probe.kernel.launches
    total, squares = probe.channel_stats(x)
    assert probe.kernel.launches == before   # no kernel launch on the CPU
    assert total.dtype == squares.dtype == torch.float32
    assert total.shape == squares.shape == (probe.LANES,)
    x64 = x.to(torch.float64).numpy()
    np.testing.assert_allclose(total.numpy(), x64.sum(0), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(squares.numpy(), (x64 ** 2).sum(0), rtol=1e-5)
    for got, want in zip((total, squares), probe.channel_stats_plain(x)):
        assert torch.equal(got, want)


def test_channel_stats_validates_its_input():
    with pytest.raises(ValueError, match="128"):
        probe.channel_stats(torch.zeros((4, 64), dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        probe.channel_stats(torch.zeros((4, 128)))
    with pytest.raises(ValueError, match="contiguous"):
        probe.channel_stats(
            torch.zeros((8, 128), dtype=torch.bfloat16)[::2])


def test_probe_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe would run")
    assert probe.main() == 1
