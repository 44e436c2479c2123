"""Top-k selection of the serving lanes: the keys and the plain version.

Counterpart of `retinanet_tpu/ops/postprocess.py:37-97` (`_orderable_u16`,
`_unorderable_u16`, `approx_max_k_packed`) and of `jax.lax.top_k`.

Every selection here orders the elements of a row by one key, descending,
and takes the first k: the element's value key, then the lower index among
equal value keys. The three modes differ in the value key and in the value
returned:

* "packed" (bf16 rows of n <= 2^17 elements): the JAX package's default
  serving lane, `approx_max_k_packed`. Its sort key is
  `(orderable_u16(v) >> drop) << idx_bits | (mask - idx)` with
  `idx_bits = bit_length(n - 1)` and `drop = 16 - min(16, 32 - idx_bits)`:
  value major, ties to the lower index. The value returned is the one the
  key keeps, `unorderable_u16((orderable_u16(v) >> drop) << drop)`: with
  drop 1 the low bit of the orderable code is cleared, which moves a
  positive logit toward zero and a negative one away from it.
* "bf16" (bf16 rows above 2^17 elements, where `approx_max_k_packed` falls
  back to `lax.approx_max_k`; and `lax.top_k` on bf16): the k largest bf16
  values, ties to the lower index.
* "f32" (float32 rows: the exact lane `use_approx_top_k=false`, the
  `skip_nms` export lane, the final top-k over the NMS survivors):
  `lax.top_k`, whose order is the total order of the floats (-0.0 below
  0.0), ties to the lower index.

Recall. Off the TPU, XLA computes `approx_max_k` exactly: a top-L by value
(L >= k, from the recall target), then the packed sort over those L. So the
default lane is a deterministic function, and every mode here is exact
(recall 1). It equals the JAX package's CPU result whenever the top-L by
value holds every element whose packed key is among the k largest, which
fails only when more than L - k values tie at the L-th place. The recall
target is read and checked (`check_recall_target`) and changes nothing. In
"bf16" mode XLA's fallback orders equal values in no fixed order; the
values agree, and the index sets above the k-th value.

`select_top_k` reaches the kernel of `csrc/topk.cu` on a CUDA tensor
through the custom op `retinanet_torch::top_k_rows`
(`ops/topk_kernel.py`); `top_k_rows_plain` below is the plain version,
which the op takes for a tensor on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

MODES = ("packed", "bf16", "f32")
PACKED_MAX_ROW = 1 << 17    # above, idx_bits > 17 and the key exceeds u32


def check_recall_target(recall_target: float) -> float:
    """`inference.approx_recall_target` must lie in (0, 1]. Every mode is
    exact, so the value changes no result."""
    recall_target = float(recall_target)
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"approx_recall_target must lie in (0, 1], got "
                         f"{recall_target}")
    return recall_target


def packed_layout(n: int) -> Tuple[int, int]:
    """(idx_bits, drop) of the packed key over rows of n elements."""
    idx_bits = max(int(n - 1).bit_length(), 1)
    if idx_bits > 17:
        raise ValueError(f"the packed key takes rows of at most "
                         f"{PACKED_MAX_ROW} elements, got {n}")
    return idx_bits, 16 - min(16, 32 - idx_bits)


def lane_mode(dtype: torch.dtype, n: int, approx: bool) -> str:
    """The mode the JAX package's selection takes for rows of n elements of
    `dtype`: `approx_max_k_packed` when `approx`, else `lax.top_k`. With
    float32 rows the approximate lane is `lax.approx_max_k`, exact here."""
    if dtype == torch.bfloat16:
        return "packed" if approx and n <= PACKED_MAX_ROW else "bf16"
    if dtype == torch.float32:
        return "f32"
    raise TypeError(f"top-k takes bfloat16 or float32, got {dtype}")


def orderable_u16(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> its orderable code in int32 [0, 65535]: integer order is
    float order (finite inputs). Positive: set the sign bit; negative:
    invert all bits."""
    bits = x.view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(bits < 0x8000, bits | 0x8000, bits ^ 0xFFFF)


def unorderable_u16(code: torch.Tensor) -> torch.Tensor:
    """Inverse of `orderable_u16`: int32 codes -> bf16."""
    bits = torch.where(code >= 0x8000, code & 0x7FFF, code ^ 0xFFFF)
    bits = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    return bits.to(torch.int16).view(torch.bfloat16)


def orderable_u32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its orderable code in int64 [0, 2^32): the total order of
    the floats, as `lax.top_k` sorts them."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(bits < 0x80000000, bits | 0x80000000,
                       bits ^ 0xFFFFFFFF)


def unorderable_u32(code: torch.Tensor) -> torch.Tensor:
    """Inverse of `orderable_u32`: int64 codes -> float32."""
    bits = torch.where(code >= 0x80000000, code & 0x7FFFFFFF,
                       code ^ 0xFFFFFFFF)
    bits = torch.where(bits >= 0x80000000, bits - 0x100000000, bits)
    return bits.to(torch.int32).view(torch.float32)


def value_key(x: torch.Tensor, mode: str, n: int) -> torch.Tensor:
    """The value part of each element's key, in int64, for rows of n."""
    if mode == "f32":
        return orderable_u32(x)
    code = orderable_u16(x).to(torch.int64)
    return code >> packed_layout(n)[1] if mode == "packed" else code


def key_value(key: torch.Tensor, mode: str, n: int) -> torch.Tensor:
    """The value a key keeps, in the input's type."""
    if mode == "f32":
        return unorderable_u32(key)
    drop = packed_layout(n)[1] if mode == "packed" else 0
    return unorderable_u16((key << drop).to(torch.int32))


def check_rows(x: torch.Tensor, k: int, mode: str) -> None:
    """What the op takes: x (B, N, C), the type of `mode`, 1 <= k <= N."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, C), got {tuple(x.shape)}")
    want = torch.float32 if mode == "f32" else torch.bfloat16
    if x.dtype != want:
        raise TypeError(f"mode {mode!r} takes {want}, got {x.dtype}")
    n = x.shape[1]
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= N, got k={k}, N={n}")
    if mode == "packed":
        packed_layout(n)


def top_k_rows_plain(x: torch.Tensor, k: int, mode: str
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: for each (b, c) of x (B, N, C), the k largest
    keys along N, by a stable descending sort of the value key (lower index
    first among equals), cut to k. Returns values (B, C, k) in x's type and
    indices (B, C, k) int32, in key order."""
    check_rows(x, k, mode)
    n = x.shape[1]
    key = value_key(x.transpose(1, 2), mode, n)              # (B, C, N)
    order = torch.sort(key, dim=-1, descending=True,
                       stable=True).indices[..., :k]
    top = torch.gather(key, -1, order)
    return key_value(top, mode, n), order.to(torch.int32)


def select_top_k(x: torch.Tensor, k: int, mode: str, dim: int = -1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest elements along `dim` in `mode` (values in x's type,
    int32 indices, in key order). `dim=1` of a (B, N, C) tensor selects
    along N for every (b, c) and returns (B, C, k), reading x in place;
    `dim=-1` selects along the last axis and returns x.shape[:-1] + (k,).
    On a CUDA tensor one launch of the kernel, else the plain version."""
    ndim = x.dim()
    if dim < 0:
        dim += ndim
    if dim == ndim - 1:
        rows = x.reshape(-1, x.shape[-1], 1)
    elif dim == 1 and ndim == 3:
        rows = x
    else:
        raise ValueError(f"select_top_k takes dim=1 of a (B, N, C) tensor "
                         f"or the last axis, got dim={dim} of "
                         f"{tuple(x.shape)}")
    values, idx = torch.ops.retinanet_torch.top_k_rows(
        rows.contiguous(), int(k), mode)
    if dim == ndim - 1:
        shape = tuple(x.shape[:-1]) + (k,)
        return values.reshape(shape), idx.reshape(shape)
    return values, idx
