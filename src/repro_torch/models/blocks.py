"""Layer blocks and the layer stack.

The reference scans groups of identical layers over stacked parameters
(``lax.scan``); the port keeps one parameter dict per layer and runs the
stack as a Python loop.  ``group_pattern`` stays: ``convert.py`` needs it
to split the reference's stacked groups.

Zamba2-style ``shared_attn`` blocks share one parameter set, stored once
at the top of the model's params (``params["shared_attn"]``, passed to
``apply_stack`` as ``shared``); each occurrence's entry in the layer list
is ``{}`` and keeps its own KV cache.  Mamba blocks carry a conv and SSM
state instead of a KV cache, on either layout request.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, \
    create_selective_checkpoint_contexts

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import apply_norm, init_norm
from repro_torch.models.mlp import init_mlp
from repro_torch.models.opts import DEFAULT_OPTS, ModelOpts
from repro_torch.models.tp import gather_fsdp, mlp_tp

_STACK_KINDS = ("attn_moe", "attn_mlp", "mamba", "shared_attn")


@dataclass(frozen=True)
class Group:
    spec: BlockSpec
    count: int
    start: int   # first layer index


def group_pattern(pattern: Tuple[BlockSpec, ...]) -> List[Group]:
    """Runs of consecutive identical specs (the reference's scan groups)."""
    groups: List[Group] = []
    i = 0
    while i < len(pattern):
        j = i
        while j < len(pattern) and pattern[j] == pattern[i]:
            j += 1
        groups.append(Group(pattern[i], j - i, i))
        i = j
    return groups


def _check_kind(spec: BlockSpec) -> None:
    if spec.kind not in _STACK_KINDS:
        raise NotImplementedError(
            f"{spec.kind!r} blocks are a placeholder kind: no config of "
            f"the reference runs one; the stack takes {_STACK_KINDS}")


def init_block(gen: torch.Generator, cfg: ModelConfig, spec: BlockSpec,
               device) -> Dict:
    _check_kind(spec)
    if spec.kind == "mamba":
        return {"norm1": init_norm(cfg, device),
                "mixer": ssm_mod.init_mamba(gen, cfg, device)}
    p = {
        "norm1": init_norm(cfg, device),
        "attn": attn_mod.init_attention(gen, cfg, device),
        "norm2": init_norm(cfg, device),
    }
    if spec.kind == "attn_moe":
        p["moe"] = moe_mod.init_moe(gen, cfg, device)
    else:                                   # attn_mlp / shared_attn
        p["mlp"] = init_mlp(gen, cfg, device)
    return p


def apply_block(
    params: Dict,
    cfg: ModelConfig,
    spec: BlockSpec,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    mode: str,
    cache: Optional[Dict],
    opts: ModelOpts = DEFAULT_OPTS,
    block_tables=None,
    kernel_blocks: Optional[int] = None,
    k_budget: Optional[torch.Tensor] = None,
    lookahead_h2: Optional[torch.Tensor] = None,
    mesh=None,
):
    """Returns (x, cache, aux_loss, h2), ``h2`` the block's pre-FFN hidden.
    ``k_budget`` [B] int32 caps each batch row's active experts below
    ``spec.moe_top_k`` (every token of the row takes the row's cap).

    ``lookahead_h2`` (router lookahead) is the previous layer's pre-FFN
    hidden, from which this block predicts its top-k expert ids before its
    own attention runs; the MoE's plain decode path stages its weight
    gathers on the prediction, and no output depends on it.

    A mamba block returns ``h2`` None; it has no chunk mode.

    ``mesh`` (bound): x is the rank's data block of the rows, the same on
    every rank of ``model``, and the params the rank's blocks
    (``sharding.local_params``); the attention, the MLP and the mamba
    mixer run tensor parallelism over ``model`` (``models/tp.py``), the
    MoE the impl ``moe.mesh_impl`` picks, and with
    ``opts.decode_kv_seq_shard`` the GQA cache is the rank's sequence
    block (context parallelism); an MLA layer attends its whole latent
    cache on every rank under the flag too, as the reference."""
    _check_kind(spec)
    if spec.kind == "mamba":
        if mode == "chunk":
            raise NotImplementedError(
                "chunked prefill needs conv/state carry across chunks; "
                "mamba blocks use whole-prompt prefill (serving/runner.py)")
        h, cache = ssm_mod.mamba_forward(
            params["mixer"], cfg, apply_norm(params["norm1"], cfg, x),
            mode=mode, cache=cache, mesh=mesh)
        return (x + h, cache,
                torch.zeros((), dtype=torch.float32, device=x.device), None)
    pred_idx = None
    if lookahead_h2 is not None and spec.kind == "attn_moe":
        d = lookahead_h2.shape[-1]
        pred_idx = moe_mod.route_lookahead(
            params["moe"], cfg, lookahead_h2.reshape(-1, d), spec.moe_top_k)
    attn_kw = {"block_tables": block_tables,
               "use_paged_kernel": opts.use_paged_kernel,
               "kernel_blocks": kernel_blocks}
    if cfg.attention == "mla":
        attn_kw["absorb"] = opts.mla_absorb
    else:
        attn_kw.update(use_flash=opts.use_flash,
                       compute_dtype=opts.attn_compute_dtype,
                       use_flash_decode=opts.use_flash_decode,
                       seq_shard=opts.decode_kv_seq_shard)
    h, cache = attn_mod.attention(
        params["attn"], cfg, apply_norm(params["norm1"], cfg, x), positions,
        mode=mode, cache=cache, mesh=mesh, **attn_kw)
    x = x + h
    h2 = apply_norm(params["norm2"], cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.kind == "attn_moe":
        kb_tok = None
        if k_budget is not None:
            b, s, _ = h2.shape
            kb_tok = k_budget.to(torch.int32)[:, None].expand(b, s).reshape(-1)
        impl = moe_mod.mesh_impl(opts.moe_impl or cfg.moe_impl, cfg, mode,
                                 h2.shape[0] * h2.shape[1], mesh)
        y, aux = moe_mod.moe(
            params["moe"], cfg, h2, spec.moe_top_k, impl=impl, mesh=mesh,
            use_kernel=opts.use_moe_kernel, a2a_chunks=opts.a2a_chunks,
            decode_kernel=opts.use_moe_decode_kernel and mode == "decode",
            expert_dtype=opts.expert_dtype, pred_idx=pred_idx,
            k_budget=kb_tok)
        x = x + y
    else:
        x = x + mlp_tp(params["mlp"], h2, mesh, cfg.d_ff)
    return x, cache, aux, h2


#: matmuls with no batch dims, whose outputs ``remat="dots"`` keeps (the
#: reference's ``checkpoint_dots_with_no_batch_dims``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, remat: str) -> Callable:
    """``fn`` under activation checkpointing: its backward recomputes the
    whole forward ("full") or all but the kept matmul outputs ("dots")."""
    if remat == "full":
        return partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return partial(checkpoint, fn, use_reentrant=False, context_fn=partial(
            create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat={remat!r}; want 'none', 'full' or 'dots'")


def init_stack(gen: torch.Generator, cfg: ModelConfig, device) -> List[Dict]:
    """One parameter dict per layer (``{}`` for a shared_attn occurrence:
    its weights are ``init_shared``'s)."""
    return [{} if spec.kind == "shared_attn"
            else init_block(gen, cfg, spec, device)
            for spec in cfg.pattern()]


def init_shared(gen: torch.Generator, cfg: ModelConfig,
                device) -> Optional[Dict]:
    """The one parameter set of the stack's shared_attn blocks, or None
    when the pattern has none."""
    if not any(s.kind == "shared_attn" for s in cfg.pattern()):
        return None
    return init_block(gen, cfg, BlockSpec("shared_attn"), device)


def init_stack_cache(cfg: ModelConfig, batch: int = 0, max_len: int = 0, *,
                     layout: str = "contiguous", page_size: int = 16,
                     num_pages: int = 0, device) -> List[Dict]:
    """One cache per layer: a paged pool of ``num_pages`` x ``page_size``
    positions, or ``batch`` contiguous rows for ``max_len`` positions; a
    mamba layer's conv and SSM state (``batch`` rows) on either layout, as
    in the reference."""
    if layout not in ("paged", "contiguous"):
        raise ValueError(f"unknown cache layout {layout!r}")

    def one(spec):
        if spec.kind == "mamba":
            return ssm_mod.init_mamba_cache(cfg, batch, device)
        if layout == "paged":
            return attn_mod.init_paged_cache(cfg, num_pages, page_size,
                                             device)
        return attn_mod.init_cache(cfg, batch, max_len, device)
    return [one(spec) for spec in cfg.pattern()]


def apply_stack(layers: List[Dict], cfg: ModelConfig, x, positions, *,
                mode: str, caches=None, opts: ModelOpts = DEFAULT_OPTS,
                block_tables=None, kernel_blocks: Optional[int] = None,
                k_budgets=None, shared: Optional[Dict] = None, mesh=None,
                layout=None):
    """Run every layer.  Returns (x, caches, total_aux).  ``shared`` is the
    shared_attn blocks' one parameter set (``init_shared``); ``mesh`` goes
    to every block (``apply_block``).  ``layout``: the params' FSDP
    ``Sharding`` tree (``rules.fsdp_layout``) under
    ``opts.fsdp_params``: each layer's leaves are gathered over the data
    axes where the layer runs (inside its remat, so the backward gathers
    them again).

    ``k_budgets`` [B, n_moe] int32 gives each batch row a per-MoE-layer
    active-expert cap below the pattern's per-layer top-k (per-request
    LExI plans): MoE layer i takes column i, counted over the MoE layers
    only, as the reference's running index does.

    With ``opts.router_lookahead`` a decode step carries each layer's
    pre-FFN hidden to the next (``h2_prev``), from which that layer
    predicts its expert ids; zeros feed the first layer, whose staged loads
    then just miss.  The carry passes over mamba blocks unchanged.

    In train mode ``opts.remat`` checkpoints each layer (``_remat``); with
    ``opts.remat_chunk`` = G > 1 a run of more than G identical layers is
    checkpointed G layers at a time instead (its whole chunks; the
    remainder layers each on their own), as the reference's two-level
    remat: G times fewer stashed activations for the same recompute."""
    remat = opts.remat if mode == "train" else "none"
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    lookahead = opts.router_lookahead and mode == "decode"
    h2_prev = torch.zeros_like(x) if lookahead else None
    pattern = cfg.pattern()
    moe_idx, n = [], 0
    for spec in pattern:
        moe_idx.append(n if spec.kind == "attn_moe" else None)
        n += spec.kind == "attn_moe"

    def layer_fn(li: int, h2_in=None) -> Callable:
        spec = pattern[li]
        kb = None
        if k_budgets is not None and moe_idx[li] is not None:
            kb = k_budgets[:, moe_idx[li]]
        own = spec.kind == "shared_attn"
        lp = shared if own else layers[li]
        lay = None
        if layout is not None:
            lay = layout["shared_attn"] if own else layout["layers"][li]

        def run(x):
            p = gather_fsdp(lp, lay, mesh, opts)
            return apply_block(
                p, cfg, spec, x, positions=positions, mode=mode,
                cache=caches[li] if caches is not None else None, opts=opts,
                block_tables=block_tables, kernel_blocks=kernel_blocks,
                k_budget=kb, lookahead_h2=h2_in, mesh=mesh)
        return run

    chunks = _remat_chunks(pattern, opts.remat_chunk if remat != "none"
                           else 0)
    li = 0
    while li < len(pattern):
        if li in chunks:
            end = chunks[li]
            fns = [layer_fn(i) for i in range(li, end)]

            def chunk(x, fns=fns):
                auxs = []
                for fn in fns:
                    x, _, a, _ = fn(x)
                    auxs.append(a)
                return x, torch.stack(auxs)
            x, auxs = _remat(chunk, "full")(x)
            for aux in auxs:                # each layer's, in layer order
                total_aux = total_aux + aux
            li = end
            continue
        gl = lookahead and pattern[li].kind != "mamba"
        layer = layer_fn(li, h2_prev if gl else None)
        if remat != "none":
            layer = _remat(layer, remat)
        x, _, aux, h2 = layer(x)
        if gl:
            h2_prev = h2
        total_aux = total_aux + aux
        li += 1
    return x, caches, total_aux


def _remat_chunks(pattern, size: int) -> Dict[int, int]:
    """First layer -> end of each whole chunk of ``size`` layers in the
    runs of identical layers longer than ``size`` (the reference's
    ``remat_chunk`` over its stacked groups); none for ``size`` <= 1."""
    if size <= 1:
        return {}
    out: Dict[int, int] = {}
    for g in group_pattern(pattern):
        if g.count > size:
            for c in range(g.count // size):
                start = g.start + c * size
                out[start] = start + size
    return out
