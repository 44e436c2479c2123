"""The weight-only int8 lane (`export/quantize.py`) against the JAX
package's, on the CPU.

  * `quantize_params` on the port's weights (`convert.torch_to_flax`: the
    OIHW kernels back in flax's HWIO layout) gives JAX's q, scale and
    stats bit for bit, and `dequantize_params` JAX's float32 products.
  * The port's `params_int8.msgpack` is read by flax (`from_bytes` against
    JAX's own quantized tree as the template), equal.
  * The weight-only serving lane matches JAX's `make_quantized_serving_fn`
    at `test_torch_serving.py`'s bounds (valid counts and classes equal,
    boxes and scores within 1e-5; the class bias shifted as in
    `test_torch_export.py`).
"""

import pytest

torch = pytest.importorskip("torch")

import flax.serialization  # noqa: E402
import jax  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_tpu.export import serving as jax_serving  # noqa: E402
from retinanet_tpu.export.quantize import \
    dequantize_params as jax_dequantize  # noqa: E402
from retinanet_tpu.export.quantize import \
    make_quantized_serving_fn as jax_quantized_fn  # noqa: E402
from retinanet_tpu.export.quantize import \
    quantize_params as jax_quantize  # noqa: E402
from retinanet_torch.convert import torch_to_flax  # noqa: E402
from retinanet_torch.export import msgpack_codec  # noqa: E402
from retinanet_torch.export.quantize import (  # noqa: E402
    dequantize_params, make_quantized_serving_fn, quantize_params)

from test_torch_export import ATOL, pair  # noqa: E402,F401


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(value, dict):
            yield from _leaves(value, path)
        else:
            yield path, np.asarray(value)


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        assert got[path].dtype == value.dtype, path
        np.testing.assert_array_equal(got[path], value, err_msg=path)


def test_quantize_params_bit_equal_to_jax(pair):
    _, variables, _, tmodel, _ = pair
    want, want_stats = jax_quantize(jax.device_get(variables["params"]))
    port_params = torch_to_flax(tmodel.state_dict())["params"]
    got, stats = quantize_params(port_params)
    assert stats == want_stats
    assert stats["quantized"] > 0 and stats["bytes_q"] < stats["bytes_fp32"]
    _assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, want))
    _assert_trees_equal(dequantize_params(got), jax.tree_util.tree_map(
        np.asarray, jax_dequantize(want)))


def test_int8_weights_file_is_read_by_flax(pair, tmp_path):
    _, variables, _, tmodel, _ = pair
    want, _ = jax_quantize(jax.device_get(variables["params"]))
    got, _ = quantize_params(torch_to_flax(tmodel.state_dict())["params"])
    path = tmp_path / "params_int8.msgpack"
    msgpack_codec.write_file(str(path), got)
    template = jax.tree_util.tree_map(np.zeros_like, want)
    restored = flax.serialization.from_bytes(template, path.read_bytes())
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, restored),
                        jax.tree_util.tree_map(np.asarray, want))
    _assert_trees_equal(msgpack_codec.read_file(str(path)), got)


def test_weight_only_lane_matches_jax(pair):
    jparams, variables, tparams, tmodel, images = pair
    qparams, _ = jax_quantize(jax.device_get(variables["params"]))
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jax_quantized_fn(
        jax_serving.build_serving_fn(jparams), qparams))(
            variables["batch_stats"], images))
    port_q, _ = quantize_params(torch_to_flax(tmodel.state_dict())["params"])
    serve = make_quantized_serving_fn(
        tparams, port_q, torch_to_flax(tmodel.state_dict())["batch_stats"],
        device="cpu")
    got = {k: v.numpy() for k, v in serve(torch.from_numpy(images)).items()}
    n = want["valid_detections"]
    assert int(n.sum()) > 0
    for b in range(2):
        assert np.all(np.diff(want["scores"][b][:n[b]]) < -1e-4)
    np.testing.assert_array_equal(got["valid_detections"], n)
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=ATOL)
