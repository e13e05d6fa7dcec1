"""Expert-parallel impls: ``ep_a2a`` (train / prefill) and ``ep_psum``
(decode), as ``repro.models.moe.ep``.

``ep_a2a``: tokens sharded over every mesh axis, experts sharded over
``model``.  Scatter into per-expert capacity buffers, ``all_to_all`` over
the model axis, the grouped expert FFN (the ``moe_ffn`` kernel on
``[E_loc, model * C, D]``), a2a back, weighted combine.  Collective bytes
scale with sum_j k_j -- a LExI plan buys communication, not just FLOPs.

``ep_psum``: activations replicated over ``model``, each rank computes
only its local experts' contribution (``moe_ffn`` on ``[E_loc, C, D]``),
partial outputs are ``psum``-reduced.  The right pattern when T (= the
decode batch) is small.

The reference's functions take the global token array under ``jit`` and
``shard_map`` it; the port's are a per-rank program: each takes and
returns **the rank's own tokens** (``ep_a2a``: the rank's block over
every axis; ``ep_psum``: its data block, the same on every rank of a
``model`` group) and the rank's ``[E / model, ...]`` expert slice
(``sharding.local_params``) on a bound mesh.  Every rank of a ``model``
group passes the same token count.  The aux loss is the mean of the
ranks' own (each rank's router statistics over its tokens), as the
reference's ``pmean``.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe.compute import add_shared, expert_ffn
from repro_torch.models.moe.dispatch import _gather_combine, _scatter, \
    _slot_positions
from repro_torch.models.moe.router import capacity, route
from repro_torch.sharding import comm


def _local_experts(params: Dict, cfg: ModelConfig, model_size: int) -> int:
    e = cfg.num_experts
    if e % model_size or params["w1"].shape[0] != e // model_size:
        raise ValueError(
            f"expert parallelism over model={model_size}: {e} experts, "
            f"the rank holds {params['w1'].shape[0]} (want the rank's "
            "slice, sharding.local_params)")
    return e // model_size


def moe_ep_a2a_local(params, cfg: ModelConfig, x_local, top_k: int, *,
                     mesh, model_axis: str, model_size: int, all_axes,
                     use_kernel: bool = False, a2a_chunks: int = 1):
    """The rank's tokens x_local [T_loc, D]; expert params sliced
    [E_loc, ...]."""
    e = cfg.num_experts
    e_loc = _local_experts(params, cfg, model_size)
    t_loc, d = x_local.shape
    cap = capacity(t_loc, top_k, e, cfg.moe_capacity_factor)

    weights, idx, aux = route(params, cfg, x_local, top_k)
    pos, keep = _slot_positions(idx, e, cap)
    buf = _scatter(x_local, idx, pos, keep, e, cap)               # [E,C,D]
    buf = buf.reshape(model_size, e_loc, cap, d)

    def run_chunk(b):
        # b [ms, E_loc, C', D] -> recv indexed by source shard on axis 0
        c = b.shape[2]
        recv = comm.all_to_all(b, mesh, model_axis)
        xe = recv.transpose(0, 1).reshape(e_loc, model_size * c, d)
        ye = expert_ffn(params["w1"], params["w2"], xe, use_kernel)
        ye = ye.reshape(e_loc, model_size, c, d).transpose(0, 1)
        return comm.all_to_all(ye, mesh, model_axis)

    if a2a_chunks > 1 and cap % a2a_chunks == 0:
        # split the capacity dim (the reference's overlap lever; here the
        # chunks run one after the other)
        back = torch.cat([run_chunk(b) for b in
                          buf.chunk(a2a_chunks, dim=2)], dim=2)
    else:
        back = run_chunk(buf)

    ye_local = back.reshape(e, cap, d)
    y = _gather_combine(ye_local, weights, idx, pos, keep,
                        cap).to(x_local.dtype)
    y = add_shared(params, cfg, x_local, y)
    return y, comm.pmean(aux, mesh, all_axes)


def moe_ep_psum_local(params, cfg: ModelConfig, x_rep, top_k: int, *,
                      mesh, model_axis: str, model_size: int, token_axes,
                      use_kernel: bool = False):
    """``x_rep`` [T, D] the same on every rank of the model axis; expert
    params sliced [E_loc, ...].  Local contributions + psum."""
    e_loc = _local_experts(params, cfg, model_size)
    midx = mesh.axis_index(model_axis)
    t, d = x_rep.shape

    weights, idx, aux = route(params, cfg, x_rep, top_k)
    lo = midx * e_loc
    local = (idx >= lo) & (idx < lo + e_loc)                      # [T, k]
    idx_loc = torch.where(local, idx - lo, e_loc)                 # -> trash
    w_loc = torch.where(local, weights, 0.0)

    # worst case: all T*k slots land on one local expert -> cap = T*k is
    # always safe; keep it tighter with the same global-capacity heuristic
    cap = capacity(t, top_k, e_loc, cfg.moe_capacity_factor)
    pos, keep = _slot_positions(idx_loc, e_loc + 1, cap)
    keep = keep & local
    xe = _scatter(x_rep, idx_loc, pos, keep, e_loc + 1, cap)[:e_loc]
    ye = expert_ffn(params["w1"], params["w2"], xe, use_kernel)
    ye_pad = torch.cat([ye, ye.new_zeros((1, cap, d))], dim=0)
    y = _gather_combine(ye_pad, w_loc, idx_loc, pos, keep, cap)
    y = comm.psum(y, mesh, model_axis).to(x_rep.dtype)
    y = add_shared(params, cfg, x_rep, y)
    # aux is invariant over the model axis (same routing on every model
    # rank): reduce over the token axes only
    if token_axes:
        aux = comm.pmean(aux, mesh, token_axes)
    return y, aux


def _axes(mesh):
    all_axes = tuple(mesh.axis_names)
    return all_axes, tuple(a for a in all_axes if a != "model")


def moe_ep_a2a(params: Dict, cfg: ModelConfig, x2d, top_k: int, *, mesh,
               use_kernel: bool = False, a2a_chunks: int = 1):
    """``moe_ep_a2a_local`` over a bound (..., model) mesh: x2d is the
    rank's block of the tokens sharded over every axis."""
    all_axes, _ = _axes(mesh)
    return moe_ep_a2a_local(params, cfg, x2d, top_k, mesh=mesh,
                            model_axis="model",
                            model_size=mesh.shape["model"],
                            all_axes=all_axes, use_kernel=use_kernel,
                            a2a_chunks=a2a_chunks)


def moe_ep_psum(params: Dict, cfg: ModelConfig, x2d, top_k: int, *, mesh,
                use_kernel: bool = False):
    """``moe_ep_psum_local`` over a bound (..., model) mesh: x2d is the
    rank's data block of the tokens, replicated over ``model``."""
    _, token_axes = _axes(mesh)
    return moe_ep_psum_local(params, cfg, x2d, top_k, mesh=mesh,
                             model_axis="model",
                             model_size=mesh.shape["model"],
                             token_axes=token_axes, use_kernel=use_kernel)
