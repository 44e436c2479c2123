"""The port's Executor introspection against the JAX package, on the config
of `tests/test_introspection.py` (ResNet10, FPN 16, 64x64): `get_flops`
counts exactly the 2 x multiply-adds of the `stablehlo.convolution` ops in
the lowered text of JAX's eval forward, and `dump_forward_hlo` writes the
`torch.export` graph of the same forward with one `aten.convolution` node
a JAX convolution."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_tpu.train import step as jax_step  # noqa: E402
from retinanet_tpu.train.executor import Executor as JaxExecutor  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.train.executor import Executor  # noqa: E402

import test_introspection  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


CONV_FLOPS = 150_555_648    # the lowered text's 31 convolutions, batch 1
CONVS = 31

_SHAPE = re.compile(r"tensor<([\dx]+)x[a-z]+\d*>")


def _tree(tmp_path):
    return test_introspection._params(tmp_path).to_dict()


def stablehlo_conv_flops(text: str) -> tuple:
    """(count, 2 x multiply-adds) of the `stablehlo.convolution` ops of a
    lowered module: each output element takes kh * kw * (input channels of
    its group) multiply-adds, from the HWIO kernel's type."""
    count = flops = 0
    for line in text.splitlines():
        if "stablehlo.convolution" not in line:
            continue
        _, kernel, out = (tuple(int(v) for v in s.split("x"))
                          for s in _SHAPE.findall(line.split(" : ")[-1]))
        kh, kw, ci, _ = kernel
        count += 1
        flops += 2 * int(np.prod(out)) * kh * kw * ci
    return count, flops


@pytest.fixture(scope="module")
def jax_lowered(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax")
    ex = JaxExecutor(test_introspection._params(tmp), run_mode="export",
                     enable_tensorboard=False)
    fwd = jax_step.make_eval_forward(ex.model, ex.compute_dtype)
    images = jnp.zeros((1, 64, 64, 3), jnp.float32)
    text = jax.jit(fwd).lower(ex.state.params, ex.state.batch_stats,
                              images).as_text()
    return ex, text


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = pathlib.Path(tmp_path_factory.mktemp("port"))
    ex = Executor(torch_cfg.from_dict(_tree(tmp)), run_mode="export",
                  device="cpu")
    yield ex
    ex.close()


def test_get_flops_equals_jax_convolutions(jax_lowered, port):
    jax_ex, text = jax_lowered
    count, flops = stablehlo_conv_flops(text)
    assert (count, flops) == (CONVS, CONV_FLOPS)
    assert port.get_flops(1) == flops
    assert port.get_flops(batch_size=2) == 2 * flops
    # XLA's cost analysis of the compiled CPU forward, for the record: it
    # counts the graph after the CPU compiler's rewrites (CHANGES.md)
    print(f"port get_flops(1) = {port.get_flops(1):,.0f}; JAX's "
          f"get_flops(1) (XLA cost analysis) = {jax_ex.get_flops(1):,.0f}")


def test_get_flops_uses_no_live_memory(port):
    """The count runs on `device="meta"`: the live model is not touched."""
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    was_training = port.model.training
    port.get_flops(4)
    assert port.model.training == was_training
    for k, v in port.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_dump_forward_hlo_writes_the_export_graph(port, tmp_path):
    path = port.dump_forward_hlo()
    assert path == str(pathlib.Path(port.model_dir) / "forward.export.txt")
    text = pathlib.Path(path).read_text()
    assert text.count("torch.ops.aten.convolution.default(") == CONVS
    # the batch-1 input at the config's shape, in the compute dtype
    assert '"f32[1, 64, 64, 3]"' in text
    other = port.dump_forward_hlo(str(tmp_path / "g.txt"))
    assert other == str(tmp_path / "g.txt")
    assert pathlib.Path(other).read_text().count(
        "torch.ops.aten.convolution.default(") == CONVS
