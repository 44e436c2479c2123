"""Two processes of the port over gloo against the JAX package's one-device
train step at the same global batch, on the CPU.

Seeded numpy weights go into the flax model and, through
`retinanet_torch.convert`, into both processes of the port. Each process
steps on its half of the same seeded batches of 4; the jitted JAX step
takes them whole. Bounds as `test_torch_train_step.py`'s: every loss rtol
1e-4, `gradient-norm` rtol 1e-3, and after the steps every parameter and
running statistic within 1e-3 of its leaf's largest magnitude. One JAX
compile.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from retinanet_torch.convert import torch_to_flax  # noqa: E402
from retinanet_torch.tools.multiprocess_smoke import run_group  # noqa: E402
from test_torch_distributed import (  # noqa: E402
    STEPS, WORLD, global_batches, rank_steps)
from test_torch_train_step import (  # noqa: E402
    LOSS_KEYS, _assert_trees_close, _build_pair, _tree)


def test_two_processes_match_the_jax_step(tmp_path):
    tree = _tree()
    (jstate, jstep), (tstate, _) = _build_pair(tree)
    weights = tmp_path / "weights.pt"
    torch.save(tstate.model.state_dict(), weights)
    run_group(rank_steps, WORLD, tmp_path,
              args=(str(tmp_path), json.loads(json.dumps(tree)),
                    str(weights), STEPS), timeout=240)
    jax_history = []
    for batch in global_batches(STEPS):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        jax_history.append(jm)
    assert int(jstate.step) == STEPS
    for rank in range(WORLD):
        history, state = torch.load(tmp_path / f"steps{rank}.pt",
                                    weights_only=False)
        for got, jm in zip(history, jax_history):
            for key in LOSS_KEYS:
                assert got[key] == pytest.approx(float(jm[key]), rel=1e-4,
                                                 abs=1e-7), key
            assert got["gradient-norm"] == pytest.approx(
                float(jm["gradient-norm"]), rel=1e-3)
        flax = torch_to_flax(state)
        _assert_trees_close(jstate.params, flax["params"], bound=1e-3)
        _assert_trees_close(jstate.batch_stats, flax["batch_stats"],
                            bound=1e-3)
