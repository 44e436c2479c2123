"""Memory-bandwidth probe: what does this card stream on BatchNorm-shaped
tensors? (Counterpart of `tools/membw_experiments.py` of the JAX package.)

    python -m retinanet_torch.tools.membw_experiments

Times a copy, PyTorch's per-lane reductions and the Triton kernel
`channel_stats` on the conv1 output of the flagship train step viewed as
(819200, 128) bf16, and prints the achieved GB/s of logical traffic (input
bytes read plus output bytes written) beside the card's name and power
limit. It runs on the card only. Nothing in the model calls the kernel: it
is a probe, as its TPU original was.

`channel_stats` replaces the Pallas TPU kernel
`tools/membw_experiments.py:45 pallas_channel_stats` (`pallas_call` :69).
The TPU kernel walks row chunks in order and adds into one (8, 128) f32
block; here the programs run in parallel, each sums its own run of rows in
registers (`tl.sum` over row blocks) and writes one (128,) partial, and a
small sum folds the partials. The (8, 128) layout was a TPU sublane shape:
the port returns the folded (128,) sums. Bound: a pure streaming reduction,
N * 256 bytes read once against 3.35 TB/s on an H100 (63 us at N =
819,200); 3 f32 operations per element are far below the operations bound.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Tuple

import torch

from retinanet_torch.utils.benchmark import device_time_ms

LANES = 128
# Rows a program loads at once, rows a program owns, and its warps: the best
# of a sweep over 32-256 x 256-4096 x {4, 8} on an H100 80GB HBM3 at 700 W
# (0.096 ms, 2.2 TB/s at N = 819,200; 64 x 1024 x 4 gave 0.19 ms).
BLOCK_ROWS = 256
ROWS_PER_PROGRAM = 512
NUM_WARPS = 4


class _Launches:
    """The count of kernel launches."""

    def __init__(self):
        self.launches = 0


kernel = _Launches()
_jit_kernel = None   # the @triton.jit function, made at the first launch


def channel_stats_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lane sum and sum of squares of x (N, 128), in float32."""
    x32 = x.to(torch.float32)
    return x32.sum(0), (x32 * x32).sum(0)


def _triton_kernel():
    """Import triton and define the kernel: only here, so that the module
    imports on a machine without triton."""
    global _jit_kernel, tl
    if _jit_kernel is not None:
        return _jit_kernel
    import triton
    import triton.language as tl  # noqa: F811 (the kernel's global)

    @triton.jit
    def channel_stats_kernel(x_ptr, sum_ptr, sq_ptr, n_rows,
                             ROWS: tl.constexpr, BLOCK: tl.constexpr,
                             WIDTH: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, WIDTH)
        acc = tl.zeros((WIDTH,), dtype=tl.float32)
        acc_sq = tl.zeros((WIDTH,), dtype=tl.float32)
        first = pid * ROWS
        for r in range(0, ROWS, BLOCK):
            rows = first + r + tl.arange(0, BLOCK)
            offsets = rows.to(tl.int64)[:, None] * WIDTH + cols[None, :]
            x = tl.load(x_ptr + offsets, mask=rows[:, None] < n_rows,
                        other=0.0).to(tl.float32)
            acc += tl.sum(x, axis=0)
            acc_sq += tl.sum(x * x, axis=0)
        tl.store(sum_ptr + pid * WIDTH + cols, acc)
        tl.store(sq_ptr + pid * WIDTH + cols, acc_sq)

    _jit_kernel = channel_stats_kernel
    return _jit_kernel


def channel_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, 128) bfloat16, contiguous -> (sum (128,), sumsq (128,))
    float32. The Triton kernel for a tensor on the card, the plain version
    for a tensor on the CPU."""
    if x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"x must be (N, {LANES}), got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"bfloat16 required, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cpu":
        return channel_stats_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no channel_stats kernel for device {x.device}")
    n_rows = x.shape[0]
    programs = max(1, -(-n_rows // ROWS_PER_PROGRAM))
    sums = torch.empty((programs, LANES), dtype=torch.float32,
                       device=x.device)
    squares = torch.empty_like(sums)
    jit_kernel = _triton_kernel()
    with torch.cuda.device(x.device):
        jit_kernel[(programs,)](x, sums, squares, n_rows,
                                ROWS=ROWS_PER_PROGRAM, BLOCK=BLOCK_ROWS,
                                WIDTH=LANES, num_warps=NUM_WARPS)
    kernel.launches += 1
    return sums.sum(0), squares.sum(0)


def main() -> int:
    if not torch.cuda.is_available():
        print("membw_experiments: no CUDA device; this probe runs on the "
              "card only", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    shape4 = (16, 320, 320, 64)     # conv1 output of the flagship step, NHWC
    gen = torch.Generator(device="cuda").manual_seed(0)
    x4 = torch.randn(shape4, generator=gen, device="cuda",
                     dtype=torch.float32).to(torch.bfloat16)
    x2 = x4.reshape(-1, LANES)
    bytes_in = x4.numel() * 2
    print(f"tensor: bf16{list(shape4)} = {bytes_in / 1e6:.0f} MB logical, "
          f"viewed as {list(x2.shape)}")

    def bench(name, fn, bytes_moved):
        ms = device_time_ms(fn)
        print(f"{name:42s} {ms:8.3f} ms  "
              f"{bytes_moved / ms / 1e6:8.1f} GB/s", flush=True)

    bench("copy (y = x + 1)", lambda: x2 + 1.0, bytes_in * 2)
    bench("sum-to-scalar f32", lambda: x2.sum(dtype=torch.float32), bytes_in)
    bench("per-lane sum f32 (torch, axis 0)",
          lambda: x2.sum(0, dtype=torch.float32), bytes_in)
    bench("per-lane sum+sumsq f32 (plain)",
          lambda: channel_stats_plain(x2), bytes_in)
    bench("triton channel_stats sum+sumsq",
          lambda: channel_stats(x2), bytes_in)
    got, want = channel_stats(x2), channel_stats_plain(x2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-2)
    print("triton channel_stats agrees with the plain version (rtol 1e-3)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
