"""The band layout of spatial partitioning (`retinanet_torch/parallel/
spatial.py`) and every band op of `models/layers.py`, in one process.

S threads stand for the S ranks of a spatial group: each takes its rows of
the whole input as the layout gives them, runs the op under its own
partition, and the partitions' all-reduce is a sum over the threads (in
rank order, at a barrier). The bands' outputs, stacked in rank order, must
equal the op on the whole tensor exactly in float32: the exchange moves bits
and each output pixel is computed from the same inputs in the same order.
Gradients through the exchange: within 1e-6 of the largest magnitude of the
whole op's (the halo rows' gradients and the kernel's over the bands are
summed in another order).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from retinanet_torch.models import layers  # noqa: E402
from retinanet_torch.models.resnet import ResNet  # noqa: E402
from retinanet_torch.parallel.spatial import (  # noqa: E402
    Partition, band_rows)
from test_torch_threads import one_thread  # noqa: E402,F401


SPATIAL = [2, 3, 4]
S_IDS = [f"s{s}" for s in SPATIAL]


class ThreadGroup:
    """The all-reduce of `count` threads: each thread's tensor is replaced
    by the sum of all of them, added in rank order."""

    def __init__(self, count: int):
        self.count = count
        self.barrier = threading.Barrier(count, timeout=30)
        self.slots = [None] * count

    def reducer(self, index: int):
        def reduce_(tensor):
            self.slots[index] = tensor.clone()
            self.barrier.wait()
            total = self.slots[0].clone()
            for other in self.slots[1:]:
                total += other
            self.barrier.wait()
            tensor.copy_(total)
            return tensor
        return reduce_


def run_bands(count, fn, image_hw, registered=()):
    """fn(rank, partition) in `count` threads under their partitions; the
    results in rank order. `registered`: (height, width) of the maps given
    to fn whole (the layout of an op's input that no op made)."""
    group = ThreadGroup(count)
    results, errors = [None] * count, []

    def body(rank):
        try:
            part = Partition(rank, count, group.reducer(rank), image_hw)
            for h, w in registered:
                part.register(h, w)
            with layers.spatial_partition(part):
                results[rank] = fn(rank, part)
        except BaseException as error:  # noqa: B902 - surfaced below
            errors.append(error)
            group.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(count)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return results


def band(x, count, rank, axis=2):
    lo, hi = band_rows(x.shape[axis], count, rank)
    return x.narrow(axis, lo, hi - lo)


def assert_bands_equal(bands, whole):
    got = torch.cat(bands, dim=2)
    assert got.shape == whole.shape
    assert torch.equal(got, whole), float((got - whole).abs().max())


def rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, shape).astype(np.float32))


def conv_params(cin, cout, k, groups=1, seed=1):
    p = layers.ConvParams(cin, cout, k, groups=groups)
    with torch.no_grad():
        p.weight.copy_(rand(*p.weight.shape, seed=seed))
        p.bias.copy_(rand(cout, seed=seed + 1))
    return p


@pytest.mark.parametrize("count", [1, 2, 3, 4, 5],
                         ids=["s1", "s2", "s3", "s4", "s5"])
@pytest.mark.parametrize("height", [0, 1, 2, 3, 5, 30, 80],
                         ids=["h0", "h1", "h2", "h3", "h5", "h30", "h80"])
def test_band_rows_cover_the_map_once(height, count):
    rows = [band_rows(height, count, r) for r in range(count)]
    assert rows[0][0] == 0 and rows[-1][1] == height
    for (_, hi), (lo, _) in zip(rows, rows[1:]):
        assert hi == lo
    sizes = [hi - lo for lo, hi in rows]
    assert max(sizes) - min(sizes) <= 1


def test_band_rows_of_the_configs():
    # 640's P3-P7 over 2, JAX's test height of 30 over 4, and the 64 test
    # size's P6 over 2, where rank 0 owns nothing
    assert [band_rows(5, 2, r) for r in range(2)] == [(0, 2), (2, 5)]
    assert [band_rows(30, 4, r) for r in range(4)] == [
        (0, 7), (7, 15), (15, 22), (22, 30)]
    assert [band_rows(1, 2, r) for r in range(2)] == [(0, 0), (0, 1)]


@pytest.mark.parametrize("count", SPATIAL, ids=S_IDS)
@pytest.mark.parametrize("height", [3, 13, 16], ids=["h3", "h13", "h16"])
@pytest.mark.parametrize("stride", [1, 2], ids=["s1", "s2"])
@pytest.mark.parametrize("k", [1, 3, 5, 7], ids=["k1", "k3", "k5", "k7"])
def test_conv2d_same_on_bands(k, stride, height, count):
    x = rand(2, 3, height, 11)
    p = conv_params(3, 4, k)
    whole = layers.conv2d_same(x, p, stride, torch.float32)
    bands = run_bands(count, lambda r, part: layers.conv2d_same(
        band(x, count, r), p, stride, torch.float32), (height, 11))
    assert_bands_equal(bands, whole)


@pytest.mark.parametrize("count", SPATIAL, ids=S_IDS)
def test_depthwise_and_explicit_pad_convs_on_bands(count):
    x = rand(2, 6, 14, 9)
    dw = conv_params(6, 6, 5, groups=6)
    p = conv_params(6, 4, 3)
    whole = layers.conv2d(layers.conv2d_same(x, dw, 2, torch.float32), p, 1,
                          1, torch.float32)
    bands = run_bands(count, lambda r, part: layers.conv2d(
        layers.conv2d_same(band(x, count, r), dw, 2, torch.float32), p, 1, 1,
        torch.float32), (14, 9))
    assert_bands_equal(bands, whole)


@pytest.mark.parametrize("count", SPATIAL, ids=S_IDS)
@pytest.mark.parametrize("height", [21, 32], ids=["h21", "h32"])
def test_resnet_stem_on_bands(height, count):
    """The stem's 7x7/2 conv with fixed padding (3, 3), its BatchNorm on the
    running statistics, relu and the 3x3/2 "SAME" max pool."""
    torch.manual_seed(0)
    net = ResNet(depth=10).eval()
    layers.init_parameters(net, torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.stem_bn.bn.running_mean.copy_(rand(64, seed=3) * 0.1)
        net.stem_bn.bn.running_var.copy_(rand(64, seed=4).abs() + 0.5)

    def stem(x):
        x = torch.relu(net.stem_bn(net.stem(x)))
        return layers.max_pool(x, 3, 2, padding="SAME")

    x = rand(2, 3, height, height)
    with torch.no_grad():
        whole = stem(x)
        bands = run_bands(count, lambda r, part: stem(band(x, count, r)),
                          (height, height))
    assert_bands_equal(bands, whole)


@pytest.mark.parametrize("count", SPATIAL, ids=S_IDS)
@pytest.mark.parametrize("pool", [
    (3, 2, "SAME"), (2, 2, "SAME"), (4, 4, "SAME"), (8, 8, "SAME"),
    (2, 2, "VALID"), (4, 4, "VALID")],
    ids=["3s2same", "2s2same", "4s4same", "8s8same", "2s2valid",
         "4s4valid"])
@pytest.mark.parametrize("height", [5, 10, 17], ids=["h5", "h10", "h17"])
def test_max_pool_on_bands(height, pool, count):
    window, stride, padding = pool
    if padding == "VALID" and height < window:
        pytest.skip("a VALID window taller than the map has no output")
    x = rand(2, 3, height, 12)
    whole = layers.max_pool(x, window, stride, padding)
    bands = run_bands(count, lambda r, part: layers.max_pool(
        band(x, count, r), window, stride, padding), (height, 12))
    assert_bands_equal(bands, whole)


@pytest.mark.parametrize("count", SPATIAL, ids=S_IDS)
@pytest.mark.parametrize("sizes", [(5, 10), (5, 9), (3, 5), (1, 2), (20, 40)],
                         ids=["5to10", "5to9", "3to5", "1to2", "20to40"])
def test_upsample_and_crop_on_bands(sizes, count):
    """The FPN's top-down path: x2 upsample, cropped to the lower level."""
    h, low_h = sizes
    x, like = rand(2, 3, h, h), rand(2, 3, low_h, low_h, seed=2)
    whole = layers.upsample_crop(x, 2, like)
    plain = layers.nearest_upsample(x, 2)
    bands = run_bands(count, lambda r, part: (
        layers.upsample_crop(band(x, count, r), 2, band(like, count, r)),
        layers.nearest_upsample(band(x, count, r), 2)),
        (h, h), registered=[(low_h, low_h)])
    assert_bands_equal([b[0] for b in bands], whole)
    assert_bands_equal([b[1] for b in bands], plain)


@pytest.mark.parametrize("count", SPATIAL, ids=S_IDS)
@pytest.mark.parametrize("sizes", [
    ((5, 5), (40, 40)), ((5, 7), (13, 20)), ((10, 10), (40, 40)),
    ((7, 6), (3, 2)), ((1, 1), (5, 5))],
    ids=["5to40", "5x7to13x20", "10to40", "7x6to3x2", "1to5"])
def test_resize_nearest_on_bands(sizes, count):
    (h, w), out = sizes
    x = rand(2, 3, h, w)
    whole = layers.resize_nearest(x, out)
    bands = run_bands(count, lambda r, part: layers.resize_nearest(
        band(x, count, r), out), (h, w))
    assert_bands_equal(bands, whole)


@pytest.mark.parametrize("count", SPATIAL, ids=S_IDS)
def test_balance_features_on_bands(count):
    """The flagship's P3-P7 heights at 640 (80 ... 5), P7 resized by 8 onto
    P4 and every level back."""
    heights = {3: 80, 4: 40, 5: 20, 6: 10, 7: 5}
    feats = {str(l): rand(1, 2, h, h, seed=l) for l, h in heights.items()}
    balance = layers.BalanceFeatures(3, 7, 4)
    whole = balance(feats)
    bands = run_bands(count, lambda r, part: balance(
        {k: band(v, count, r) for k, v in feats.items()}),
        (80, 80), registered=[(h, h) for h in heights.values()])
    for key in whole:
        assert_bands_equal([b[key] for b in bands], whole[key])


@pytest.mark.parametrize("count", SPATIAL, ids=S_IDS)
def test_spatial_mean_on_bands(count):
    x = rand(2, 5, 9, 7)
    whole = layers.spatial_mean(x)
    bands = run_bands(count, lambda r, part: layers.spatial_mean(
        band(x, count, r)), (9, 7))
    for got in bands:
        torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("count", SPATIAL, ids=S_IDS)
def test_gradients_through_the_exchange(count):
    """A 3x3/2 conv, a 3x3 "SAME" max pool and a mean: the input's and the
    kernel's gradients (summed over the bands) against the whole op's."""
    x = rand(2, 3, 15, 8)
    p = conv_params(3, 4, 3)
    dy = rand(2, 4, 8, 4, seed=5)

    def op(x):
        y = layers.conv2d_same(x, p, 2, torch.float32)
        return layers.max_pool(y, 3, 1, "SAME") * layers.spatial_mean(y)

    xw = x.clone().requires_grad_()
    (op(xw) * dy).sum().backward()
    want_dx, want_dw = xw.grad, p.weight.grad.clone()
    p.weight.grad = None

    def ranked(r, part):
        xb = band(x, count, r).clone().requires_grad_()
        w = p.weight.detach().clone().requires_grad_()
        q = layers.ConvParams(3, 4, 3)
        q.weight = torch.nn.Parameter(w)
        q.bias = torch.nn.Parameter(p.bias.detach().clone())
        y = layers.conv2d_same(xb, q, 2, torch.float32)
        out = layers.max_pool(y, 3, 1, "SAME") * layers.spatial_mean(y)
        (out * band(dy, count, r)).sum().backward()
        return xb.grad, q.weight.grad

    grads = run_bands(count, ranked, (15, 8))
    for got, want in ((torch.cat([g[0] for g in grads], dim=2), want_dx),
                      (sum(g[1] for g in grads), want_dw)):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())


def test_maps_of_one_width_and_two_heights_raise():
    part = Partition(0, 2, lambda t: t, (8, 6))
    part.register(8, 6)
    with pytest.raises(ValueError, match="width 6"):
        part.register(4, 6)
    with pytest.raises(ValueError, match="no map of width 5"):
        part.height(torch.zeros(1, 1, 2, 5))
