"""The histogram modes of activation calibration (`export/calibration.py`)
against the JAX package's, on the CPU: ResNet10 with an FPN and the heads
on the same weights and images; percentile and entropy thresholds
(127 * scale) within one bin (amax / 2048) of JAX's, since a value within
rounding of a bin edge may fall on either side. (The entropy sweep is
numpy loops, ~6 s a package: one file of its own.)"""

import pytest

torch = pytest.importorskip("torch")


from retinanet_tpu.export.calibration import \
    calibrate_activations as jax_calibrate  # noqa: E402
from retinanet_torch.export.calibration import (  # noqa: E402
    NUM_BINS, calibrate_activations)

from test_torch_int8_calibration import _setup  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


@pytest.mark.parametrize("mode", ["percentile", "entropy"])
def test_histogram_modes_within_one_bin_of_jax(mode):
    jmodel, variables, tmodel, batches = _setup("resnet10")
    amax = jax_calibrate(jmodel, variables, batches, mode="minmax")
    want = jax_calibrate(jmodel, variables, batches, mode=mode)
    got = calibrate_activations(tmodel, batches, mode=mode)
    assert sorted(got) == sorted(want)
    clipped = 0
    for key in want:
        a = amax[key] * 127.0
        bin_width = a / NUM_BINS
        assert abs(got[key] - want[key]) * 127.0 <= bin_width * (1 + 1e-5), \
            (key, got[key], want[key])
        clipped += want[key] < amax[key] * (1 - 1e-6)
    assert clipped > 0   # the mode clipped something: the bins mattered
