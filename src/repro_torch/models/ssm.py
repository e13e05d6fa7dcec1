"""Mamba2 (SSD / state-space duality) block, the port of
``repro.models.ssm``.

Chunked SSD forward for train and prefill (O(S*Q) memory with chunk length
Q), in f32 einsums, with the inter-chunk recurrence a Python loop over the
chunks; and an O(1)-state recurrent step for decode.

State cache (per layer)::

    {"conv": [B, W-1, Cc], "state": [B, H, P, N]}

with Cc = d_inner + 2*N conv channels, H heads of size P, state size N.
Prefill and decode write the cache tensors in place (``copy_``): a decode
step captured as a CUDA graph reads and writes them at the addresses it
was captured at.  As in the reference, prefill starts the scan from the
cache's ``state``; the serving engine zeroes a slot's row at admission.

Under a bound ``mesh`` (tensor parallelism, ``models/tp.py``): ``w_in``
is replicated, so every rank projects and convolves every channel (the
conv state is whole on every rank), and ``w_out`` is row-parallel over
``d_inner``.  Where the heads split over ``model``, a rank runs the SSD
for its heads only (its block of ``state``), and the gated RMSNorm, which
normalizes over the whole ``d_inner``, sums its squares over ``model``;
where they do not, every rank runs every head and keeps its channels
after the norm.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, param_dtype
from repro_torch.models.tp import TP
from repro_torch.sharding import comm


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    n = cfg.ssm_state_size
    conv_ch = d_in + 2 * n        # x, B, C share the conv (ngroups = 1)
    return d_in, nheads, cfg.ssm_head_dim, n, conv_ch


def init_mamba(gen: torch.Generator, cfg: ModelConfig, device) -> Dict:
    dt = param_dtype(cfg)
    d = cfg.d_model
    d_in, h, p, n, cc = _dims(cfg)
    # dt bias initialized so softplus(dt_bias) spans ~[1e-3, 1e-1]
    u = torch.rand(h, generator=gen, device=device, dtype=torch.float32)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt0 = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))    # inverse softplus
    conv_w = torch.randn((cfg.ssm_conv_width, cc), generator=gen,
                         device=device, dtype=torch.float32)
    return {
        "w_in": dense_init(gen, (d, 2 * d_in + 2 * n + h), dt, device),
        "conv_w": (conv_w / cfg.ssm_conv_width).to(dt),
        "conv_b": torch.zeros(cc, dtype=dt, device=device),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones(h, dtype=torch.float32, device=device),
        "dt_bias": dt_bias,
        "norm_scale": torch.ones(d_in, dtype=dt, device=device),
        "w_out": dense_init(gen, (d_in, d), dt, device, in_axis_size=d_in),
    }


def _causal_conv(xbc, w, b):
    """Depthwise causal conv, width W: xbc [B,S,Cc], w [W,Cc]."""
    width = w.shape[0]
    s = xbc.shape[1]
    xp = F.pad(xbc, (0, 0, width - 1, 0))
    y = sum(xp[:, i:i + s, :] * w[i] for i in range(width))
    return y + b


def _conv_step(xbc_t, conv_state, w, b):
    """One-token conv: xbc_t [B,Cc], conv_state [B,W-1,Cc] (oldest
    first) -> (conv output [B,Cc], the next conv state [B,W-1,Cc])."""
    window = torch.cat([conv_state, xbc_t[:, None, :].to(conv_state.dtype)],
                       dim=1)                                  # [B,W,Cc]
    y = torch.einsum("bwc,wc->bc", window.float(), w.float()) + b.float()
    return y.to(xbc_t.dtype), window[:, 1:, :]


def _split_proj(cfg: ModelConfig, zxbcdt):
    d_in, h, p, n, cc = _dims(cfg)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + cc],
            zxbcdt[..., d_in + cc:])


class _MambaTP:
    """The rank's share of a mamba mixer (module doc): ``rows`` where
    ``w_out``'s rows split over ``model``, ``split`` where the heads do
    too, and the rank's heads [lo, hi)."""

    def __init__(self, cfg: ModelConfig, mesh):
        d_in, h, self.p, _, _ = _dims(cfg)
        self.tp = TP(mesh)
        self.rows = self.tp.splits(d_in)
        self.split = self.rows and self.tp.splits(h)
        self.lo, self.hi = ((self.tp.r * (h // self.tp.m),
                             (self.tp.r + 1) * (h // self.tp.m))
                            if self.split else (0, h))

    def part(self, t):
        """A tensor every rank holds whole, read by the rank's heads."""
        return self.tp.f(t) if self.split else t

    def heads(self, t):
        """The rank's heads of a [.., H] tensor."""
        return self.part(t)[..., self.lo:self.hi]

    def channels(self, t):
        """The rank's heads' channels of a [.., d_inner] tensor."""
        return self.part(t)[..., self.lo * self.p:self.hi * self.p]


def _gated_out(params, cfg: ModelConfig, y, z, mt: _MambaTP,
               eps: float = 1e-6):
    """y, z [.., d_in'] (the rank's heads' channels): RMSNorm(y * silu(z))
    @ w_out, the norm over the whole d_inner."""
    g = y.float() * F.silu(z.float())
    if mt.split:
        d_in = _dims(cfg)[0]
        var = comm.psum(g.square().sum(-1, keepdim=True), mt.tp.mesh,
                        "model") / d_in
    else:
        var = g.square().mean(-1, keepdim=True)
    g = g * torch.rsqrt(var + eps) * mt.channels(params["norm_scale"]).float()
    g = g.to(y.dtype)
    if not mt.rows:
        return g @ params["w_out"]
    if not mt.split:                   # every head here: keep the rows
        start, size = mt.tp.block(g.shape[-1])
        g = mt.tp.f(g)[..., start:start + size]
    return mt.tp.g(g @ params["w_out"])


def mamba_forward(params: Dict, cfg: ModelConfig, x: torch.Tensor, *,
                  mode: str = "train", cache: Optional[Dict] = None,
                  mesh=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x [B,S,D] (train / prefill) or [B,1,D] (decode) -> (out [B,S,D],
    the cache -- written in place in prefill and decode -- or None).
    ``mesh`` (bound): tensor parallelism (module doc)."""
    mt = _MambaTP(cfg, mesh)
    if mode == "decode":
        return _mamba_step(params, cfg, x, cache, mt)
    if mode not in ("train", "prefill"):
        raise ValueError(f"mamba mode {mode!r}: 'train', 'prefill' or "
                         "'decode'")
    b, s, d = x.shape
    d_in, _, p, n, cc = _dims(cfg)
    h = mt.hi - mt.lo
    q = min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by ssm chunk {q}")
    nc = s // q

    z, xbc, dt_raw = _split_proj(cfg, x @ params["w_in"])
    xbc = F.silu(_causal_conv(xbc, params["conv_w"], params["conv_b"]))
    xs = mt.channels(xbc[..., :d_in]).reshape(b, s, h, p)
    bc = mt.part(xbc[..., d_in:])
    bmat = bc[..., :n]                                    # [B,S,N]
    cmat = bc[..., n:]                                    # [B,S,N]

    dt = F.softplus(mt.heads(dt_raw).float()
                    + mt.heads(params["dt_bias"]))       # [B,S,H]
    a = -torch.exp(mt.heads(params["A_log"]))             # [H] (negative)
    da = dt * a                                           # [B,S,H]

    # ---- chunked SSD ---- #
    xs_c = xs.reshape(b, nc, q, h, p).float()
    b_c = bmat.reshape(b, nc, q, n).float()
    c_c = cmat.reshape(b, nc, q, n).float()
    dt_c = dt.reshape(b, nc, q, h)
    cum = torch.cumsum(da.reshape(b, nc, q, h), dim=2)    # [B,nc,Q,H]

    # intra-chunk ("attention-like") term; the mask goes inside the exp,
    # so the masked-out (growing) exponents never overflow
    cb = torch.einsum("bcin,bcjn->bcij", c_c, b_c)        # [B,nc,Q,Q]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,nc,Q,Q,H]
    decay = torch.exp(seg.masked_fill(~mask[None, None, :, :, None],
                                      float("-inf")))
    att = cb[..., None] * decay * dt_c[:, :, None, :, :]  # [B,nc,Qi,Qj,H]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xs_c)

    # per-chunk final states
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)     # [B,nc,Q,H]
    states = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_states * dt_c,
                          b_c, xs_c)                      # [B,nc,H,P,N]

    # inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])             # [B,nc,H]
    st = (cache["state"].float() if cache is not None
          else torch.zeros((b, h, p, n), dtype=torch.float32,
                           device=x.device))
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    st_prev = torch.stack(prev, dim=1)                    # [B,nc,H,P,N]

    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", c_c, st_prev,
                           torch.exp(cum))
    y = (y_intra + y_inter).reshape(b, s, h, p)
    y = y + mt.heads(params["D"])[None, None, :, None] * xs_c.reshape(
        b, s, h, p)
    out = _gated_out(params, cfg, y.to(x.dtype).reshape(b, s, h * p),
                     mt.channels(z), mt)

    if mode == "train":
        return out, None
    pre = xbc_raw_tail(x, params, cfg, s, cfg.ssm_conv_width)
    if cache is None:
        return out, {"conv": pre, "state": st}
    cache["conv"].copy_(pre)
    cache["state"].copy_(st)
    return out, cache


def xbc_raw_tail(x, params, cfg: ModelConfig, s: int, width: int):
    """Recompute the last W-1 *pre-conv* xbc inputs (conv state for
    decode), left-padded with zeros when S < W-1."""
    tail = x[:, max(0, s - (width - 1)):, :]
    _, xbc, _ = _split_proj(cfg, tail @ params["w_in"])
    if xbc.shape[1] < width - 1:
        xbc = F.pad(xbc, (0, 0, width - 1 - xbc.shape[1], 0))
    return xbc


def init_mamba_cache(cfg: ModelConfig, batch: int, device) -> Dict:
    d_in, h, p, n, cc = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, cc),
                            dtype=param_dtype(cfg), device=device),
        "state": torch.zeros((batch, h, p, n), dtype=torch.float32,
                             device=device),
    }


def _mamba_step(params, cfg: ModelConfig, x, cache, mt: _MambaTP):
    """Single-token recurrence: x [B,1,D]; the cache updated in place."""
    b = x.shape[0]
    d_in, _, p, n, cc = _dims(cfg)
    h = mt.hi - mt.lo
    z, xbc, dt_raw = _split_proj(cfg, x[:, 0, :] @ params["w_in"])
    xbc_conv, new_conv = _conv_step(xbc, cache["conv"], params["conv_w"],
                                    params["conv_b"])
    xbc_conv = F.silu(xbc_conv)
    xs = mt.channels(xbc_conv[..., :d_in]).reshape(b, h, p).float()
    bc = mt.part(xbc_conv[..., d_in:])
    bmat = bc[..., :n].float()                            # [B,N]
    cmat = bc[..., n:].float()                            # [B,N]

    dt = F.softplus(mt.heads(dt_raw).float()
                    + mt.heads(params["dt_bias"]))       # [B,H]
    da = torch.exp(dt * -torch.exp(mt.heads(params["A_log"])))  # [B,H]
    state = (cache["state"] * da[:, :, None, None]
             + torch.einsum("bh,bn,bhp->bhpn", dt, bmat, xs))
    y = torch.einsum("bn,bhpn->bhp", cmat, state)
    y = y + mt.heads(params["D"])[None, :, None] * xs
    out = _gated_out(params, cfg, y.reshape(b, 1, h * p).to(x.dtype),
                     mt.channels(z)[:, None, :], mt)
    cache["conv"].copy_(new_conv)
    cache["state"].copy_(state)
    return out, cache
