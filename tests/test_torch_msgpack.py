"""The port's msgpack codec (`export/msgpack_codec.py`) against flax's
serialization: the port reads `flax.serialization.to_bytes` of seeded
nested trees exactly, and `flax.serialization.from_bytes` reads the
port's bytes back equal."""

import pytest

torch = pytest.importorskip("torch")

import flax.serialization  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from retinanet_torch.export import msgpack_codec  # noqa: E402


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "backbone": {"stem": {"conv": {"kernel": rng.normal(
                size=(7, 7, 3, 8)).astype(np.float32)}},
                "stem_bn": {"bn": {"scale": rng.normal(size=8).astype(
                    np.float32), "bias": np.zeros(8, np.float32)}}},
            "head": {"conv": {"kernel": {
                "q": rng.integers(-127, 128, (3, 3, 8, 16)).astype(np.int8),
                "scale": rng.uniform(1e-3, 1e-1, 16).astype(np.float32)}}},
        },
        "counts": rng.integers(-2 ** 31, 2 ** 31 - 1, (5, 2)).astype(
            np.int32),
        "flags": rng.uniform(size=(3, 4)) > 0.5,
        "bf16": np.asarray(rng.normal(size=(2, 3)), jnp.bfloat16),
        "wide": rng.normal(size=70000).astype(np.float64),
        "empty": np.zeros((0, 3), np.float32),
        "scalar": np.float32(rng.normal()),
        "nested_empty": {},
    }


def _assert_same(want, got, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for key in want:
            _assert_same(want[key], got[key], f"{path}/{key}")
        return
    if isinstance(got, torch.Tensor):   # the port's bfloat16 leaves
        assert got.dtype == torch.bfloat16, path
        got = got.view(torch.int16).numpy().view(np.uint16)
        want = np.asarray(want).view(np.uint16)
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
    assert got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("seed", [0, 1, 2], ids=["seed0", "seed1", "seed2"])
def test_port_reads_flax_bytes_exactly(seed):
    tree = _tree(seed)
    got = msgpack_codec.loads(flax.serialization.to_bytes(tree))
    _assert_same(tree, got)
    assert isinstance(got["bf16"], torch.Tensor)
    assert got["params"]["head"]["conv"]["kernel"]["q"].flags.writeable


@pytest.mark.parametrize("seed", [0, 1, 2], ids=["seed0", "seed1", "seed2"])
def test_flax_reads_port_bytes_back_equal(seed):
    tree = _tree(seed)
    port_tree = msgpack_codec.loads(flax.serialization.to_bytes(tree))
    data = msgpack_codec.dumps(port_tree)
    _assert_same(tree, flax.serialization.msgpack_restore(data))
    # from_bytes against a template, as the JAX package's load_artifact does
    kernel = tree["params"]["backbone"]["stem"]["conv"]["kernel"]
    template = {"params": {"stem": {"kernel": np.zeros_like(kernel)}}}
    restored = flax.serialization.from_bytes(template, msgpack_codec.dumps(
        {"params": {"stem": {"kernel": kernel}}}))
    _assert_same(kernel, restored["params"]["stem"]["kernel"])


def test_torch_tensors_are_written_as_their_numpy_arrays():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(4, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=3).astype(np.float32)).to(
        torch.bfloat16)
    back = flax.serialization.msgpack_restore(
        msgpack_codec.dumps({"w": w, "b": b}))
    np.testing.assert_array_equal(back["w"], w.numpy())
    assert back["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["b"]).view(np.uint16),
        b.view(torch.int16).numpy().view(np.uint16))


def test_bad_input_raises():
    data = msgpack_codec.dumps({"a": np.arange(3, dtype=np.float32)})
    assert set(msgpack_codec.loads(data)) == {"a"}
    with pytest.raises(ValueError, match="truncated"):
        msgpack_codec.loads(data[:-1])
    with pytest.raises(ValueError, match="trailing"):
        msgpack_codec.loads(data + b"\x00")
    with pytest.raises(TypeError):
        msgpack_codec.dumps({"a": object()})
    with pytest.raises(ValueError, match="not supported"):
        msgpack_codec.loads(b"\xc1")
