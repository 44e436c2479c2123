"""Two lockstep float32 train steps of MobileDet (cpu, multiplier 0.25) +
FPN-P5 against the JAX train step, on the CPU; the builder and the bounds
are `test_torch_lockstep_efficientnet.py`'s.

The cpu variant (swish6) is the one held here. In the relu6 variants
(edge_tpu, gpu) at these seeded weights, the float32 gradients of a few
backbone BN offsets and kernels are ill-conditioned: on MobileDet-gpu they
are 9% (port) and 12% (JAX) away from float64 and 11% from each other
(ROADMAP Queue 3)."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_lockstep_efficientnet import (  # noqa: E402
    two_lockstep_steps_f32)


def test_two_lockstep_steps_f32():
    two_lockstep_steps_f32("mobiledet-fpn_p5")
