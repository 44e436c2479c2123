"""The int8-activation lane against the JAX package, on the CPU.

  * The plain int8 convolution's int32 accumulators
    (`ops/int8_conv.py:int8_conv_acc`, float64 sums, exact) equal
    `lax.conv_general_dilated(int8, int8, preferred_element_type=int32)`
    bit for bit at every shape the kernel takes: stride 1 and 2, "SAME"
    with asymmetric pads, 1x1, 3x3, the 7x7 stem with C = 3, depthwise 1x1,
    3x3, 5x5 and 7x7, a non-square 3x5 and stride 3 (C = 7 among them),
    C = 6, 24 and 40, the narrow design's
    1x1, 3x3/2 and 5x5/2 at C = 4, 6, 8, 12 and 16, and the largest
    magnitude of the flagship (4,608 terms of 127 * -127).
  * The activation quantization and the epilogue equal the JAX
    interceptor's expressions under `jit`, bit for bit, in float32 and
    bfloat16.
  * The whole lane (`Int8Model`, real and fake-quant) with the same scales
    against JAX's `Int8Model` on ResNet10 + FPN at 64x64 in float32: per-
    level head outputs within LANE_ATOL, which is held at least 10x under
    the same test's JAX-int8 against JAX-float gap, and the same
    detections (valid counts and classes equal, boxes and scores within
    LANE_ATOL).
  * Excluded convs keep the float path bit for bit; the agreement AP of
    identical detections is 1.
Calibration against JAX's is in `test_torch_int8_calibration.py`.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

from retinanet_tpu.core import config as jax_cfg  # noqa: E402
from retinanet_tpu.data import anchors as jax_anchors  # noqa: E402
from retinanet_tpu.data.preprocessing import \
    make_device_normalizer as jax_normalizer  # noqa: E402
from retinanet_tpu.export.calibration import \
    calibrate_activations as jax_calibrate  # noqa: E402
from retinanet_tpu.export.quantize import \
    Int8Model as JaxInt8Model  # noqa: E402
from retinanet_tpu.ops.postprocess import \
    make_inference_fn as jax_make_inference_fn  # noqa: E402
from retinanet_torch.core import config as torch_cfg  # noqa: E402
from retinanet_torch.export.quantize import (  # noqa: E402
    Int8Model, detection_agreement_ap)
from retinanet_torch.export.serving import build_serving_fn  # noqa: E402
from retinanet_torch.models.layers import same_pads  # noqa: E402
from retinanet_torch.ops.int8_conv import (  # noqa: E402
    int8_conv2d_plain, int8_conv_acc, pack_weights, quantize_activation,
    requantize, unpack_weights)
from retinanet_torch.ops.int8_conv_kernel import int8_conv2d  # noqa: E402

from test_torch_model import _build_pair  # noqa: E402
from test_torch_threads import one_thread  # noqa: E402,F401


# The port's int8 lane against JAX's, head outputs and detections: the
# largest difference seen was 9.5e-7 (heads, real and fake) and 3.6e-7
# (boxes), float32 rounding of the float convs; the same test's JAX int8
# against JAX float gap is 0.0885 (real) and 0.0591 (fake)
LANE_ATOL = 1e-5

# (name, batch, (h, w), C, O, k, stride, groups, pads or "SAME")
_CONV_CASES = [
    ("3x3_s1_same", 2, (9, 11), 8, 12, 3, 1, 1, "SAME"),
    ("3x3_s2_same_asym", 2, (10, 12), 8, 12, 3, 2, 1, "SAME"),
    ("3x3_s2_same_odd", 1, (9, 11), 16, 8, 3, 2, 1, "SAME"),
    ("1x1_s1", 2, (6, 7), 32, 16, 1, 1, 1, (0, 0, 0, 0)),
    ("1x1_s2", 2, (8, 8), 16, 24, 1, 2, 1, (0, 0, 0, 0)),
    ("7x7_s2_c3_stem", 2, (22, 22), 3, 8, 7, 2, 1, (0, 0, 0, 0)),
    ("c6", 1, (7, 9), 6, 5, 3, 1, 1, "SAME"),
    # EfficientNet-lite's C = 24 and 40: taps padded to 32 and 64 channels
    ("c24_1x1", 2, (6, 7), 24, 16, 1, 1, 1, (0, 0, 0, 0)),
    ("c40_3x3_s2_same", 1, (9, 10), 40, 12, 3, 2, 1, "SAME"),
    ("dw3x3_s1", 2, (9, 9), 8, 8, 3, 1, 8, "SAME"),
    ("dw3x3_s2", 2, (10, 10), 12, 12, 3, 2, 12, "SAME"),
    ("dw5x5_s2", 2, (12, 13), 6, 6, 5, 2, 6, "SAME"),
    # the depthwise designs' shapes: 5x5/2 with asymmetric "SAME" pads on
    # both axes, a 1x1 depthwise conv, C = 7 ("depthwise_generic")
    ("dw5x5_s2_same_asym_c16", 2, (11, 14), 16, 16, 5, 2, 16, "SAME"),
    ("dw1x1", 2, (6, 7), 24, 24, 1, 1, 24, (0, 0, 0, 0)),
    ("dw5x5_s1_c7", 1, (9, 8), 7, 7, 5, 1, 7, "SAME"),
    # "depthwise_generic"'s other branches: a 7x7 window, a non-square 3x5
    # (k as (kh, kw)), stride 3
    ("dw7x7_s1_generic", 1, (12, 13), 16, 16, 7, 1, 16, "SAME"),
    ("dw3x5_s1_generic", 2, (9, 10), 12, 12, (3, 5), 1, 12, "SAME"),
    ("dw3x3_s3_generic", 2, (13, 14), 8, 8, 3, 3, 8, "SAME"),
    # the narrow design's classes (dense, 4 <= C <= 16): 1x1, 3x3/2 and
    # 5x5/2 "SAME" at C = 4, 6, 8, 12 and 16 where the cases above have
    # none
    ("n1x1_c4", 3, (5, 6), 4, 96, 1, 1, 1, (0, 0, 0, 0)),
    ("n1x1_c6", 2, (7, 5), 6, 24, 1, 1, 1, (0, 0, 0, 0)),
    ("n1x1_c8", 2, (6, 6), 8, 32, 1, 1, 1, (0, 0, 0, 0)),
    ("n1x1_c12", 2, (5, 7), 12, 40, 1, 1, 1, (0, 0, 0, 0)),
    ("n1x1_c16", 2, (6, 7), 16, 8, 1, 1, 1, (0, 0, 0, 0)),
    ("n3x3_s2_c4", 2, (9, 10), 4, 16, 3, 2, 1, "SAME"),
    ("n3x3_s2_c6", 1, (11, 9), 6, 12, 3, 2, 1, "SAME"),
    ("n3x3_s2_c12", 2, (10, 11), 12, 20, 3, 2, 1, "SAME"),
    ("n5x5_s2_c4", 2, (11, 12), 4, 8, 5, 2, 1, "SAME"),
    ("n5x5_s2_c6", 1, (12, 11), 6, 16, 5, 2, 1, "SAME"),
    ("n5x5_s2_c8", 2, (10, 13), 8, 12, 5, 2, 1, "SAME"),
    ("n5x5_s2_c12", 1, (13, 12), 12, 24, 5, 2, 1, "SAME"),
    ("n5x5_s2_c16", 2, (12, 12), 16, 128, 5, 2, 1, "SAME"),
]


def _window(k):
    """(kh, kw) of a case's window: k, or (kh, kw) where it is not
    square."""
    return (k, k) if isinstance(k, int) else k


def _conv_inputs(case, seed):
    _, n, (h, w), c, o, k, stride, groups, pads = case
    kh, kw = _window(k)
    rng = np.random.default_rng(seed)
    qx = rng.integers(-127, 128, (n, h, w, c)).astype(np.int8)
    qw_hwio = rng.integers(-127, 128, (kh, kw, c // groups, o)).astype(
        np.int8)
    if pads == "SAME":
        pads = same_pads(h, kh, stride) + same_pads(w, kw, stride)
    return qx, qw_hwio, pads


def _jax_acc(qx, qw_hwio, stride, padding, groups):
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(qx), jnp.asarray(qw_hwio), (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32))


@pytest.mark.parametrize("case", _CONV_CASES, ids=[c[0] for c in _CONV_CASES])
def test_plain_accumulators_equal_lax_int8_conv(case):
    _, _, _, _, _, k, stride, groups, spec = case
    kh, kw = _window(k)
    qx, qw_hwio, pads = _conv_inputs(case, seed=len(case[0]))
    # JAX's own "SAME" string where the case is SAME: the port's same_pads
    # must give lax's asymmetric split
    padding = "SAME" if spec == "SAME" else ((pads[0], pads[1]),
                                             (pads[2], pads[3]))
    want = _jax_acc(qx, qw_hwio, stride, padding, groups)
    qw = torch.from_numpy(qw_hwio.transpose(3, 2, 0, 1).copy())
    got = int8_conv_acc(torch.from_numpy(qx), qw, stride, pads, groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernel's packed layout round-trips, and the custom op's CPU
    # implementation is the plain version
    packed = pack_weights(qw, groups)
    assert torch.equal(unpack_weights(packed, qw.shape[0],
                                      qw.shape[1], kh, kw, groups), qw)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 2, qx.shape).astype(np.float32))
    scale = torch.full((qw.shape[0],), 1e-3)
    args = (x, packed, scale, None, 0.03, stride, pads, groups, kh, kw,
            torch.float32)
    assert torch.equal(int8_conv2d(*args), int8_conv2d_plain(*args))


def test_plain_accumulators_exact_at_the_largest_sum():
    """3x3 over 512 channels of 127 * -127: -74,322,432, beyond float32's
    exact integers (2^24) but exact in float64."""
    qx = np.full((1, 3, 3, 512), 127, np.int8)
    qw = np.full((3, 3, 512, 4), -127, np.int8)
    want = _jax_acc(qx, qw, 1, ((0, 0), (0, 0)), 1)
    got = int8_conv_acc(torch.from_numpy(qx), torch.from_numpy(
        qw.transpose(3, 2, 0, 1).copy()), 1, (0, 0, 0, 0), 1)
    assert int(want[0, 0, 0, 0]) == -4608 * 127 * 127
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_epilogue_equal_the_interceptor(dtype):
    rng = np.random.default_rng(4)
    s_a = 0.0137
    # values on and next to the .5 rounding boundaries, and clipped ones
    base = (np.arange(-300, 300) + 0.5) * np.float32(s_a)
    x = np.concatenate([base, np.nextafter(base, np.inf, dtype=np.float32),
                        rng.normal(0, 1, 4000)]).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    x_j = jnp.asarray(x).astype(jdt)
    # s_a traced: XLA divides. (The interceptor's s_a is a constant of the
    # program, and XLA's CPU compile turns the division by a constant into
    # a multiply by its float32 reciprocal, which rounds across a .5
    # boundary one step away for some x: the port divides, as the
    # interceptor's expression says.)
    quantize = jax.jit(lambda v, s: jnp.clip(jnp.round(
        v.astype(jnp.float32) / s), -127, 127))
    want_q = np.asarray(quantize(x_j, jnp.float32(s_a))).astype(np.int8)
    x_t = torch.from_numpy(np.array(x_j.astype(jnp.float32))).to(tdt)
    got_q = quantize_activation(x_t, s_a).numpy()
    np.testing.assert_array_equal(got_q, want_q)
    folded = np.asarray(jax.jit(lambda v: jnp.clip(jnp.round(
        v.astype(jnp.float32) / jnp.float32(s_a)), -127, 127))(x_j))
    reciprocal = np.clip(np.round(np.asarray(x_j.astype(jnp.float32))
                                  * (np.float32(1) / np.float32(s_a))),
                         -127, 127)
    np.testing.assert_array_equal(folded, reciprocal)
    assert np.abs(folded - got_q).max() <= 1

    acc = rng.integers(-74_322_432, 74_322_433, (64, 48)).astype(np.int32)
    s_w = rng.uniform(1e-4, 1e-2, 48).astype(np.float32)
    bias = rng.normal(0, 1, 48).astype(np.float32)
    scale = np.float32(s_a) * s_w
    got = requantize(torch.from_numpy(acc), torch.from_numpy(scale),
                     torch.from_numpy(bias), tdt).float().numpy()
    # two roundings, the interceptor's expression
    two = np.asarray(jnp.asarray(acc.astype(np.float32) * scale + bias)
                     .astype(jdt).astype(jnp.float32))
    np.testing.assert_array_equal(got, two)
    # XLA's CPU compile contracts the multiply and the add into one FMA:
    # at most one ulp of the output dtype apart
    fused = np.asarray(jax.jit(lambda a, sw, b: (
        a.astype(jnp.float32) * (jnp.float32(s_a) * sw) + b).astype(jdt))(
            acc, s_w, bias).astype(jnp.float32))
    fma = (acc.astype(np.float32).astype(np.float64)
           * scale.astype(np.float64) + bias).astype(np.float32)
    if dtype == "float32":
        np.testing.assert_array_equal(fused, fma)
    ulp = np.spacing(np.abs(got)) * (1 if dtype == "float32" else 2 ** 16)
    assert np.all(np.abs(fused - got) <= ulp)


_TREE = {
    "experiment": {"name": "int8_port"},
    "input": {"input_shape": [64, 64], "channels": 3},
    "floatx": {"precision": "float32"},
    "architecture": {
        "backbone": {"type": "resnet", "depth": 10},
        "feature_fusion": {"type": "fpn", "filters": 16, "min_level": 3,
                           "max_level": 5, "backbone_max_level": 5},
        "head": {"num_convs": 1, "filters": 16, "num_classes": 6,
                 "num_anchors": 9},
    },
    "anchor_params": {"areas": [1024.0, 4096.0, 16384.0],
                      "aspect_ratios": [0.5, 1.0, 2.0],
                      "scales": [1.0, 2 ** (1 / 3), 2 ** (2 / 3)]},
    "inference": {"pre_nms_top_k": 200, "max_detections": 25,
                  "score_threshold": 0.05, "mode": "PerClassHardNMS",
                  "use_approx_top_k": False},
}


@pytest.fixture(scope="module")
def lane():
    """Both models on the same weights, raw images, the normalized images
    that both packages' normalizers give, and JAX's minmax scales on
    them."""
    jmodel, variables, tmodel = _build_pair(_TREE, seed=0)
    tmodel.eval()
    jparams = jax_cfg.from_dict(_TREE)
    normalize = jax.jit(jax_normalizer(jparams))
    rng = np.random.default_rng(0)
    raw = [rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
           for _ in range(2)]
    normalized = [np.asarray(normalize(x)) for x in raw]
    scales = jax_calibrate(jmodel, variables, normalized, mode="minmax")
    return jmodel, variables, tmodel, raw, normalized, scales


def _heads(out):
    return {f"{kind}/{lvl}": np.asarray(v, np.float32)
            for kind in ("class-predictions", "box-predictions")
            for lvl, v in out[kind].items()}


def _torch_heads(model, images):
    with torch.inference_mode():
        out = model(torch.from_numpy(images))
    return {f"{kind}/{lvl}": v.numpy()
            for kind in ("class-predictions", "box-predictions")
            for lvl, v in out[kind].items()}


@pytest.mark.parametrize("real_int8", [True, False], ids=["real", "fake"])
def test_int8_lane_head_outputs_match_jax(lane, real_int8):
    jmodel, variables, tmodel, _, normalized, scales = lane
    images = normalized[0]
    apply = jax.jit(lambda v, x: JaxInt8Model(
        jmodel, scales, real_int8=real_int8).apply(v, x, train=False))
    want = _heads(apply(variables, images))
    fp = _heads(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, images))
    got = _torch_heads(Int8Model(tmodel, scales, real_int8=real_int8),
                       images)
    port_gap = max(np.abs(got[k] - want[k]).max() for k in want)
    jax_gap = max(np.abs(fp[k] - want[k]).max() for k in want)
    assert port_gap <= LANE_ATOL, (port_gap, jax_gap)
    assert 10 * LANE_ATOL <= jax_gap, (port_gap, jax_gap)


@pytest.mark.parametrize("real_int8", [True, False], ids=["real", "fake"])
def test_int8_lane_detections_match_jax(lane, real_int8):
    jmodel, variables, tmodel, raw, _, scales = lane
    jparams = jax_cfg.from_dict(_TREE)
    tparams = torch_cfg.from_dict(_TREE)
    infer = jax.jit(jax_make_inference_fn(
        JaxInt8Model(jmodel, scales, real_int8=real_int8), jparams,
        jax_anchors.from_params(jparams), jax_normalizer(jparams),
        compute_dtype=jnp.float32))
    if real_int8:  # the lane as build_serving_fn(int8_scales=) builds it
        serve = build_serving_fn(tparams, device="cpu", model=tmodel,
                                 int8_scales=scales)
    else:
        serve = build_serving_fn(tparams, device="cpu", model=Int8Model(
            tmodel, scales, real_int8=False))
    for images in raw:
        want = jax.tree_util.tree_map(np.asarray, infer(
            variables["params"], variables["batch_stats"], images))
        got = {k: v.numpy() for k, v in serve(
            torch.from_numpy(images)).items()}
        assert want["valid_detections"].sum() > 0
        np.testing.assert_array_equal(got["valid_detections"],
                                      want["valid_detections"])
        np.testing.assert_array_equal(got["classes"], want["classes"])
        np.testing.assert_allclose(got["scores"], want["scores"],
                                   rtol=0, atol=LANE_ATOL)
        np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                                   atol=LANE_ATOL)


def test_excluded_convs_keep_the_float_path(lane):
    _, _, tmodel, _, normalized, scales = lane
    pred_only = {k: v for k, v in scales.items() if "prediction" in k}
    assert pred_only
    with torch.inference_mode():
        fp = tmodel(torch.from_numpy(normalized[0]))
    q_model = Int8Model(tmodel, pred_only)
    assert q_model.num_int8_convs == 0
    q = _torch_heads(q_model, normalized[0])
    for kind in ("class-predictions", "box-predictions"):
        for lvl, v in fp[kind].items():
            assert np.array_equal(v.numpy(), q[f"{kind}/{lvl}"])


def test_agreement_ap_identity_is_one(lane):
    _, _, tmodel, raw, _, _ = lane
    tparams = torch_cfg.from_dict(_TREE)
    serve = build_serving_fn(tparams, device="cpu", model=tmodel)
    det = {k: v.numpy() for k, v in serve(torch.from_numpy(raw[0])).items()}
    assert det["valid_detections"].sum() > 0
    ap = detection_agreement_ap(det, det, (64, 64), min_score=0.05)
    assert ap == pytest.approx(1.0, abs=1e-6)
