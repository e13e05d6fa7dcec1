"""What one launch of each kernel does, from its arguments' shapes alone.

Each function takes a wrapper's arguments and returns the ``Cost`` of the
launch they make: the FLOPs as the kernel computes them (B2: the causal
half of the score and value products, cut further by a window; the
products at f32 or bf16 as the kernel runs them, two FLOPs a multiply-add)
and the bytes with each input read once and each output written once (the
kernels' scratch is not counted).  ``chip_smoke.py``'s ``bound_ms``
reckons the same way, but counts only the *live* part that its inputs'
values select: the cache positions that hold a key (B4, B8), B1's valid
tiles, B3's and B5's distinct routed experts.  These costs read no value,
so they count what the launch is sized for: every slot of the cache or of
the walked table columns, every tile, and ``min(E, slots)`` experts (one
expert at most a routed slot or a tile).

Both routes report the same cost (``report``): the ``meta`` route, which
checks what the card's route checks, returns empty outputs and computes
nothing (the dry run, ``launch/dryrun.py``), and the CUDA route after each
launch.  The plain version reports nothing: its aten ops are counted as
they run (``analysis/counters.py``).  A CUDA graph's replay runs no
wrapper, so it reports nothing either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

BF16 = 2


@dataclass(frozen=True)
class Cost:
    flops: int
    nbytes: int


def report(name: str, cost: Cost) -> None:
    """Hand one launch's cost to the open counters
    (``analysis.counters.count``)."""
    from repro_torch.analysis.counters import add_kernel
    add_kernel(name, cost.flops, cost.nbytes)


def _size(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def causal_pairs(s: int, window: Optional[int]) -> int:
    """(query, key) pairs a causal (windowed) mask leaves visible."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    # rows i < window see i + 1 keys, the rest see window
    return window * (window + 1) // 2 + (s - window) * window


def flash_attention(q, k, v, window: Optional[int]) -> Cost:
    """B2: q [B, Hq, S, hd], k / v [B, Hkv, S, hd] -> out like q; the score
    and value products over the visible pairs."""
    b, hq, s, hd = q.shape
    io = 2 * _size(q) + _size(k) + _size(v)
    return Cost(4 * b * hq * hd * causal_pairs(s, window), io)


def flash_decode(q, k, v, pos, cur_pos) -> Cost:
    """B8: every slot of the rows' caches (k / v [B, S, Hkv, hd], a head
    slice read as its own heads)."""
    b, hq, hd = q.shape
    s = k.shape[1]
    io = (2 * _size(q) + 2 * b * s * k.shape[2] * hd * k.element_size()
          + _size(pos) + _size(cur_pos))
    return Cost(4 * b * s * hq * hd, io)


def flash_decode_paged(q, kp, block_tables, cur_pos) -> Cost:
    """B4: every slot of the walked table columns (``n_blk`` pages of P
    slots a row), with their positions."""
    b, hq, hd = q.shape
    slots = b * block_tables.shape[1] * kp.shape[1]
    io = (2 * _size(q) + slots * (2 * kp.shape[2] * hd * kp.element_size()
                                  + 4)
          + _size(block_tables) + _size(cur_pos))
    return Cost(4 * slots * hq * hd, io)


def flash_decode_paged_mla(q_lat, q_rope, ckvp, kropep, block_tables,
                           cur_pos) -> Cost:
    """B7: every latent slot of the walked columns (latents at their own
    element size); scores over r + dr, values over r, in f32 (bf16
    latents: ``mma.sync`` on bf16 parts; f32 latents: FFMA)."""
    b, h, r = q_lat.shape
    dr = q_rope.shape[-1]
    slots = b * block_tables.shape[1] * ckvp.shape[1]
    io = (2 * _size(q_lat) + _size(q_rope)
          + slots * ((r + dr) * ckvp.element_size() + 4)
          + _size(block_tables) + _size(cur_pos))
    return Cost(slots * h * (2 * (r + dr) + 2 * r), io)


def _swiglu_flops(rows: int, d: int, f: int) -> int:
    """Up (gate and up, 2F) and down products of ``rows`` rows."""
    return rows * 6 * d * f


def _expert_bytes(experts: int, d: int, f: int, dtype: str = "bf16",
                  elem: int = BF16) -> int:
    """``experts`` experts' w1 [D, 2F] and w2 [F, D]: native ("bf16", the
    weights' own dtype) at ``elem`` bytes an element (2 bf16, 4 f32);
    quantized: int8 values (int4: two a byte) plus the f32 scale rows s1
    [2, F], s2 [F]."""
    if dtype == "bf16":
        return experts * 3 * d * f * elem
    per = 3 * d * f if dtype == "int8" else 3 * d * f // 2
    return experts * (per + 3 * f * 4)


def moe_gmm(xs, w2, tile_expert, dtype: str = "bf16") -> Cost:
    """B1 / B6: every row of the sorted buffer (dead tiles included), each
    tile's expert read once (at most one expert a tile)."""
    m, d = xs.shape
    e, f = w2.shape[0], w2.shape[1]
    n_tiles = tile_expert.shape[0]
    io = (2 * _size(xs)
          + _expert_bytes(min(e, n_tiles), d, f, dtype, w2.element_size())
          + 2 * _size(tile_expert))
    return Cost(_swiglu_flops(m, d, f), io)


def moe_decode(x, w2, idx, dtype: str = "bf16") -> Cost:
    """B3 / B5: every routed slot (B x k), each of at most ``min(E, B k)``
    distinct experts read once."""
    b, d = x.shape
    e, f = w2.shape[0], w2.shape[1]
    slots = idx.numel()
    io = (2 * _size(x)
          + _expert_bytes(min(e, slots), d, f, dtype, w2.element_size())
          + slots * 8)                       # idx int32 + weights f32
    return Cost(_swiglu_flops(slots, d, f), io)


def moe_ffn(xe, w1, w2) -> Cost:
    """B9: every expert and every capacity row, empty or not."""
    e, c, d = xe.shape
    f = w2.shape[1]
    return Cost(_swiglu_flops(e * c, d, f),
                2 * _size(xe) + _size(w1) + _size(w2))
