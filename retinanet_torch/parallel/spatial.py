"""Spatial partitioning: the rows of each image cut into bands over the S
processes of a spatial group (counterpart of the `spatial` axis of
`retinanet_tpu/parallel/mesh.py:create_mesh`, where GSPMD shards H and
inserts the convolutions' halo exchanges; here they are written out).

Layout (`band_rows`). A map of global height H is split evenly at every level
of the network: spatial rank r owns rows [r * H // S, (r + 1) * H // S). Every
map is balanced to one row, any H splits (odd heights, P7's 5 rows at 640,
JAX's test height of 30 over 4), and a level of fewer rows than S leaves some
ranks with none. The price is that an op's input and output bands need not
line up: a stride-2 conv, a pool or an upsample may need rows another rank
owns, and a general fetch brings them. Bands cut on the coarsest level's rows
and scaled up would keep the resampling inside a band, but P7's 5 rows (1 at
64) would split the work 3 : 2 (or 1 : 0), and a 3x3 conv needs its halo
either way.

Exchange (`Partition.fetch`). An op asks for the global rows [lo, hi) of its
input that its output band needs; they may reach past [0, H), where the
"SAME" padding's fill stands (zeros, -inf for a max pool), and into other
ranks' bands. Every rank computes every rank's request from the layout, so
no sizes travel. The rows a rank needs from others have a slot in one zero
buffer; each owner writes its rows into the others' slots, and one all-reduce
of the buffer as int32 words fills every slot (each word has one writer, so
the bits arrive exactly, in any dtype). The backward pass sends each rank's
gradient of the rows it fetched back the same way, and each owner adds them
into its own rows. Only all-reduce is used: NCCL and gloo on CUDA tensors
both carry it.

Every rank runs every op on every map, also where its band is empty (its
convs then run on a window of fill rows and keep none of the output), so
every rank reaches every collective in the same order, in the forward and in
the backward pass.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

Rows = Tuple[int, int]


def band_rows(height: int, count: int, index: int) -> Rows:
    """The global rows [lo, hi) of a map of `height` rows that spatial rank
    `index` of `count` owns."""
    return index * height // count, (index + 1) * height // count


@dataclasses.dataclass
class ExchangeStats:
    """What the exchanges moved since `reset`: all-reduces, rows (of every
    rank's slots), bytes, and with `timed` the seconds of the all-reduces
    alone (the device is synchronised before and after each, so timing
    slows the step)."""
    calls: int = 0
    rows: int = 0
    bytes: int = 0
    seconds: float = 0.0
    timed: bool = False

    def reset(self) -> None:
        self.calls, self.rows, self.bytes, self.seconds = 0, 0, 0, 0.0


# the counters of this process's exchanges, read and reset by the card check
STATS = ExchangeStats()


class _Plan:
    """The rows of one fetch: for every rank j, the segments of its request
    clipped to [0, H), in row order, as (g0, g1, offset): offset None for
    the rows j owns, else where the rows sit in the buffer."""

    def __init__(self, height: int, count: int, windows: Sequence[Rows]):
        self.height = height
        self.windows = [tuple(w) for w in windows]
        self.own = [band_rows(height, count, j) for j in range(count)]
        self.segments: List[List[Tuple[int, int, Optional[int]]]] = []
        offset = 0
        for (lo, hi), (a, b) in zip(self.windows, self.own):
            cl, ch = min(max(lo, 0), height), min(max(hi, 0), height)
            segments = []
            for g0, g1, mine in ((cl, min(ch, a), False),
                                 (max(cl, a), min(ch, b), True),
                                 (max(cl, b), ch, False)):
                if g0 < g1:
                    segments.append((g0, g1, None if mine else offset))
                    offset += 0 if mine else g1 - g0
            self.segments.append(segments)
        self.total = offset

    def remote(self, j: int, a: int, b: int):
        """Rank j's rows from the band [a, b): (rows in the band, rows in
        the buffer) as slices."""
        for g0, g1, off in self.segments[j]:
            i0, i1 = max(g0, a), min(g1, b)
            if off is not None and i0 < i1:
                yield (slice(i0 - a, i1 - a),
                       slice(off + i0 - g0, off + i1 - g0))


def _rows_like(x: torch.Tensor, n: int, fill: float) -> torch.Tensor:
    """n rows of `fill` shaped like x's rows, in x's memory layout."""
    b, c, _, w = x.shape
    return torch.full((b, n, w, c), fill, dtype=x.dtype,
                      device=x.device).permute(0, 3, 1, 2)


class Partition:
    """A spatial partition in force for one pass of the model: this rank's
    `index` in its spatial group of `count`, `reduce_` (sums a tensor over
    the group in place), and the global height of every map the pass has
    made, by width. A band keeps whole rows, so its width is its map's; the
    image's height and width (`image_hw`) start the table, every op that
    changes a size adds its output, and two maps of one width and different
    heights raise."""

    def __init__(self, index: int, count: int,
                 reduce_: Callable[[torch.Tensor], torch.Tensor],
                 image_hw: Sequence[int]):
        self.index = int(index)
        self.count = int(count)
        self.reduce_ = reduce_
        self.heights = {}
        self.register(int(image_hw[0]), int(image_hw[1]))

    def band(self, height: int, index: Optional[int] = None) -> Rows:
        return band_rows(height, self.count,
                         self.index if index is None else index)

    def register(self, height: int, width: int) -> None:
        known = self.heights.setdefault(int(width), int(height))
        if known != height:
            raise ValueError(
                f"two maps of width {width} have heights {known} and "
                f"{height}: a spatial partition tells its maps apart by "
                "their width")

    def height(self, x: torch.Tensor) -> int:
        """The global height of the map whose band is `x` (NCHW)."""
        try:
            return self.heights[x.shape[3]]
        except KeyError:
            raise ValueError(
                f"no map of width {x.shape[3]} was made under this spatial "
                "partition") from None

    def fetch(self, x: torch.Tensor, height: int, windows: Sequence[Rows],
              fill: float = 0.0) -> torch.Tensor:
        """The global rows windows[self.index] of the map whose band is x,
        with `fill` outside [0, height); `windows` holds every rank's
        request. Differentiable: the gradient of a fetched row goes back to
        the rank that owns it."""
        return _Fetch.apply(x, self, _Plan(height, self.count, windows), fill)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole map of which x is this rank's band, on every rank (for
        the evaluation's outputs; no gradient)."""
        height = self.height(x)
        a, b = self.band(height)

        def write(view):
            view[:, :, a:b] = x

        return self._exchange(height, x, write)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the group (differentiable: the gradient is summed
        too). For means over a map's rows."""
        return _Sum.apply(x, self)

    def _exchange(self, rows: int, like: torch.Tensor,
                  write: Callable[[torch.Tensor], None]) -> torch.Tensor:
        """A zero buffer of `rows` rows shaped like `like`'s, filled by
        `write` on each rank and summed over the group as int32 words;
        returns its (N, C, rows, W) view in like's dtype."""
        b, c, _, w = like.shape
        elems = b * rows * w * c
        words = -(-elems * like.element_size() // 4)
        raw = torch.zeros(words, dtype=torch.int32, device=like.device)
        view = raw.view(like.dtype)[:elems].view(
            b, rows, w, c).permute(0, 3, 1, 2)
        if rows:
            write(view)
            self._reduce(raw, rows)
        return view

    def _reduce(self, tensor: torch.Tensor, rows: int) -> None:
        STATS.calls += 1
        STATS.rows += rows
        STATS.bytes += tensor.numel() * tensor.element_size()
        if not STATS.timed:
            self.reduce_(tensor)
            return
        cuda = tensor.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(tensor.device)
        start = time.perf_counter()
        self.reduce_(tensor)
        if cuda:
            torch.cuda.synchronize(tensor.device)
        STATS.seconds += time.perf_counter() - start


class _Fetch(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, part: Partition, plan: _Plan, fill: float):
        me = part.index
        a, b = plan.own[me]
        lo, hi = plan.windows[me]

        def write(view):
            for j in range(part.count):
                if j != me:
                    for band, slot in plan.remote(j, a, b):
                        view[:, :, slot] = x[:, :, band]

        view = part._exchange(plan.total, x, write)
        pieces = [_rows_like(x, max(0, min(hi, 0) - lo), fill)]
        for g0, g1, off in plan.segments[me]:
            pieces.append(x[:, :, g0 - a:g1 - a] if off is None
                          else view[:, :, off:off + g1 - g0])
        pieces.append(_rows_like(x, max(0, hi - max(lo, plan.height)), fill))
        ctx.part, ctx.plan = part, plan
        ctx.x_shape = x.shape
        ctx.channels_last = x.stride(1) == 1 and x.shape[1] > 1
        return torch.cat(pieces, dim=2)

    @staticmethod
    def backward(ctx, grad):
        part, plan = ctx.part, ctx.plan
        me = part.index
        a, b = plan.own[me]
        lo = plan.windows[me][0]

        def write(view):
            for g0, g1, off in plan.segments[me]:
                if off is not None:
                    view[:, :, off:off + g1 - g0] = grad[:, :, g0 - lo:g1 - lo]

        view = part._exchange(plan.total, grad, write)
        dx = torch.empty(ctx.x_shape, dtype=grad.dtype, device=grad.device,
                         memory_format=(torch.channels_last
                                        if ctx.channels_last
                                        else torch.contiguous_format)).zero_()
        for g0, g1, off in plan.segments[me]:
            if off is None:
                dx[:, :, g0 - a:g1 - a] = grad[:, :, g0 - lo:g1 - lo]
        for j in range(part.count):
            if j != me:
                for band, slot in plan.remote(j, a, b):
                    dx[:, :, band] += view[:, :, slot]
        return dx, None, None, None


class _Sum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, part: Partition):
        ctx.part = part
        out = x.contiguous().clone()
        part.reduce_(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        ctx.part.reduce_(out)
        return out, None


def image_band(images: torch.Tensor, part: Partition) -> torch.Tensor:
    """This rank's rows of NHWC images (axis 1), at their global height."""
    lo, hi = part.band(images.shape[1])
    return images[:, lo:hi]


def partition_for(grid, image_hw: Sequence[int]) -> Partition:
    """The partition of `grid`'s spatial group (`parallel/distributed.py`)
    for images of height and width `image_hw`."""
    return Partition(grid.spatial_index, grid.spatial_count,
                     grid.sum_over_spatial_, image_hw)
