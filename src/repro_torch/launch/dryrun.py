"""Production dry run: every (arch x shape x mesh) cell's per-rank step on
the ``meta`` device, counted (the port's counterpart of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \
        --out experiments/dryrun_torch

Runs on the CPU, with no card and no ``torch.distributed`` world.  A cell
is the port's own per-rank program -- ``training.make_train_step``,
``models.prefill_fn`` or ``models.decode_fn`` on the rank's blocks of the
params, optimizer state, batch and caches (``sharding.local_params``,
``local_cache_specs``, ``training.state_shardings``) -- at full width and
depth, on a production mesh placed on one rank (``Mesh.place``): every
tensor is a ``meta`` tensor (shapes and dtypes, no memory), every
collective only counts its bytes (``sharding/comm.py``), and every kernel
wrapper checks its arguments and reports its launch's cost
(``kernels/costs.py``).  ``analysis/counters.py`` counts the step's FLOPs,
HBM bytes, collective bytes and peak live bytes, and
``analysis/roofline.py`` turns them into the three-term bound against the
H100's peaks.

Serving cells run the kernel options of the card's serving path:
``--flash`` sends prefill attention through B2 (``flash_attention``) and
decode attention through B8 (``flash_decode``), and the MoE's ``ep_a2a``
/ ``ep_psum`` run their expert FFNs through B9 (``moe_ffn``).  Train
cells run the plain paths, as ``make_train_step`` does on the card (no
kernel has a backward).

The reference compiles each cell with XLA, whose cost analysis counts a
``lax.scan`` body once, so it composes a scan-exact total from per-group
variants (``composed_costs``).  The port runs every layer and counts each
as it runs, so that composition does not come.

The program is per rank.  A cell reports rank 0; where the rank's
attention heads differ over ``model`` (a column block cutting through
heads unevenly), it also runs the rank with the most heads and reports
the larger of the two bounds (the step waits for the slowest rank).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import time
import traceback
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import models
from repro_torch.analysis import roofline as rl
from repro_torch.analysis.counters import count
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import SHAPES, SHAPE_BY_NAME, ShapeSpec, \
    applicability
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.opts import ModelOpts
from repro_torch.optim import AdamW
from repro_torch.sharding import batch_specs, local_cache_specs, \
    local_params, local_tree, named

META = torch.device("meta")


# --------------------------------------------------------------------------- #
# Cell configuration
# --------------------------------------------------------------------------- #


def cell_config(cfg: ModelConfig, shape: ShapeSpec,
                lexi_budget_frac: Optional[float] = None) -> ModelConfig:
    """Arch config adjusted for one cell (production MoE impls, etc.)."""
    kw: Dict = {}
    if cfg.is_moe:
        kw["moe_impl"] = "ep_psum" if shape.step == "decode" else "ep_a2a"
    if cfg.name == "zamba2-1.2b" and shape.name == "long_500k":
        # cap the shared attention block's window (DESIGN.md
        # §Shape-applicability)
        kw["sliding_window"] = 4096
    cfg = cfg.with_(**kw) if kw else cfg
    if lexi_budget_frac is not None and cfg.is_moe and cfg.moe_top_k > 1:
        n = cfg.num_moe_layers
        budget = max(n, int(round(lexi_budget_frac * n * cfg.moe_top_k)))
        # deterministic synthetic plan with the right budget (the dry run
        # cares about shapes; real plans come from repro_torch.core.optimize)
        base, extra = divmod(budget, n)
        plan = tuple(min(cfg.moe_top_k, base + (1 if i < extra else 0))
                     for i in range(n))
        cfg = cfg.with_lexi_plan(plan)
    return cfg


def cell_opts(cfg: ModelConfig, shape: ShapeSpec, *,
              remat: str = "full", a2a_chunks: int = 1,
              use_flash: bool = False, mla_absorb: bool = True,
              attn_compute_dtype: str = "f32",
              decode_kv_seq_shard: bool = False,
              fsdp_params: bool = False,
              microbatches: int = 1,
              remat_chunk: int = 0) -> ModelOpts:
    """The reference's ``cell_opts`` less its XLA levers (``scan_unroll``,
    ``act_constraint``).  ``use_flash`` picks the serving step's attention
    kernel (B2 in prefill, B8 in decode); a serving cell of a MoE runs
    B9 in its expert-parallel impl; a train cell runs the plain paths."""
    serve = shape.step != "train"
    return ModelOpts(remat=remat if not serve else "none",
                     a2a_chunks=a2a_chunks,
                     use_flash=use_flash and shape.step == "prefill",
                     use_flash_decode=use_flash and shape.step == "decode",
                     use_moe_kernel=serve and cfg.is_moe,
                     mla_absorb=mla_absorb,
                     attn_compute_dtype=attn_compute_dtype,
                     decode_kv_seq_shard=decode_kv_seq_shard,
                     fsdp_params=fsdp_params,
                     microbatches=microbatches,
                     remat_chunk=remat_chunk)


# --------------------------------------------------------------------------- #
# Abstract inputs per cell ("input_specs")
# --------------------------------------------------------------------------- #


def _tok(*shape):
    return torch.empty(shape, dtype=torch.int32, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict:
    """``meta`` stand-ins for every model input of this cell, at the global
    batch (the reference's ``ShapeDtypeStruct``s)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.step in ("train", "prefill"):
        s_tok = s
        extras: Dict = {}
        if cfg.is_encoder_decoder:
            extras["frames"] = torch.empty(
                (b, cfg.encoder_seq_len, cfg.d_model), device=META)
        elif cfg.prefix_embed_len:
            s_tok = s - cfg.prefix_embed_len
            extras["prefix_embeds"] = torch.empty(
                (b, cfg.prefix_embed_len, cfg.d_model), device=META)
        batch = {"tokens": _tok(b, s_tok), **extras}
        if shape.step == "train":
            batch["targets"] = _tok(b, s_tok)
            batch["mask"] = _tok(b, s_tok)
        return {"batch": batch}
    # decode: one new token against a cache of length seq_len
    return {"tokens": _tok(b), "pos": _tok(b),
            "caches": models.abstract_caches(cfg, b, s)}


# --------------------------------------------------------------------------- #
# The rank's step of a cell
# --------------------------------------------------------------------------- #


def _rows(tree, mesh: Mesh):
    """The rank's data block of a batch tree (``sharding.batch_specs``)."""
    return local_tree(tree, named(mesh, batch_specs(tree, mesh)))


def _drawn(spec, cfg: ModelConfig, shape: ShapeSpec, device, seed: int):
    """Values for ``input_specs``' stand-ins on a real device, drawn from
    ``seed``: tokens and targets uniform over the vocab, the mask all ones,
    frames and prefix embeddings standard normal, a decode row at the
    cache's last position (so that it attends every slot)."""
    from repro_torch.tree import flatten_with_paths, unflatten
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def one(path: str, t: torch.Tensor) -> torch.Tensor:
        name = path.rsplit("/", 1)[-1]
        if t.is_floating_point():
            return torch.randn(t.shape, generator=gen, device=device)
        if name == "mask":
            return torch.ones(t.shape, dtype=t.dtype, device=device)
        if name == "pos":
            return torch.full(t.shape, shape.seq_len - 1, dtype=t.dtype,
                              device=device)
        return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                             device=device, dtype=t.dtype)
    return unflatten(spec, [one(p, t) for p, t in flatten_with_paths(spec)])


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
               opts: ModelOpts, device=META, seed: int = 0
               ) -> Tuple[Callable, Dict]:
    """-> (step, inputs): ``step()`` runs the rank's step of this cell;
    ``inputs`` is what it holds from the start (its blocks of the params,
    optimizer state, batch and caches).  On ``meta`` (``mesh`` placed)
    everything is shapes; on another device (``mesh`` bound there, or
    placed there to count a real run) the params are drawn from ``seed``
    (``models.init_params``), the inputs too (``_drawn``), the caches
    empty."""
    device = torch.device(device)
    meta = device.type == "meta"
    spec = input_specs(cfg, shape)
    spec.pop("caches", None)
    if not meta:
        spec = _drawn(spec, cfg, shape, device, seed + 1)
    params = (models.abstract_params(cfg) if meta
              else models.init_params(cfg, seed, device=device))
    if opts.fsdp_params:                # its memo, outside the step
        from repro_torch.sharding import fsdp_layout
        fsdp_layout(cfg, mesh, opts.fsdp_min_size)

    if shape.step == "train":
        from repro_torch.training import TrainState, make_train_step, \
            state_shardings
        optimizer = AdamW(total_steps=10_000)
        whole = TrainState(params, optimizer.init(params), None)
        state = local_tree(whole, state_shardings(whole, cfg, mesh, opts))
        del whole, params
        batch = _rows(spec["batch"], mesh)
        train_step = make_train_step(cfg, optimizer, opts=opts, mesh=mesh,
                                     microbatches=opts.microbatches)
        return ((lambda: train_step(state, batch)),
                {"params": state.params, "opt": state.opt, "batch": batch})

    params = local_params(params, cfg, mesh, opts.fsdp_params,
                          opts.fsdp_min_size)
    b, s = shape.global_batch, shape.seq_len
    caches = (models.abstract_caches(cfg, b, s) if meta else
              models.init_caches(cfg, b, s, layout="contiguous",
                                 device=device))
    decode = shape.step == "decode"
    caches = local_tree(caches, named(mesh, local_cache_specs(
        caches, cfg, mesh, seq_shard=decode and opts.decode_kv_seq_shard)))
    if not decode:
        batch = _rows(spec["batch"], mesh)

        def prefill_step():
            return models.prefill_fn(params, cfg, batch, caches, mesh=mesh,
                                     opts=opts)
        return prefill_step, {"params": params, "batch": batch,
                              "caches": caches}

    tokens, pos = (_rows(spec[k], mesh) for k in ("tokens", "pos"))

    def serve_step():
        return models.decode_fn(params, cfg, tokens, pos, caches, mesh=mesh,
                                opts=opts)
    return serve_step, {"params": params, "batch": {"tokens": tokens,
                                                    "pos": pos},
                        "caches": caches}


def _size(tree) -> int:
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def run_rank(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh,
             opts: ModelOpts):
    """One rank's step of the cell on ``meta`` (``mesh`` placed), counted:
    -> (``analysis.counters.Counts``, the bytes of the rank's params)."""
    step, inputs = build_cell(cfg, shape, mesh, opts)
    with count(inputs) as counts:
        step()
    return counts, _size(inputs["params"])


def heaviest_model_rank(cfg: ModelConfig, mesh: Mesh) -> int:
    """The ``model`` coordinate whose rank attends the most heads (rank 0's
    where every rank attends as many): a column block that cuts through
    heads gives some ranks more of them (``models.attention._gqa_plan``,
    ``_MlaHeads``)."""
    from repro_torch.models.attention import _gqa_plan
    from repro_torch.models.tp import TP, heads_of
    m = mesh.shape.get("model", 1)
    if not cfg.num_heads:
        return 0

    def heads(r: int) -> int:
        tp = TP(None, m=m, r=r)
        if cfg.attention == "mla":
            lo, hi = heads_of(tp, cfg.num_heads, cfg.v_head_dim)
            return hi - lo
        plan = _gqa_plan(cfg, tp, False)
        return cfg.num_heads if plan is None else plan[1] - plan[0]
    counts = [heads(r) for r in range(m)]
    return counts.index(max(counts))


# --------------------------------------------------------------------------- #
# One cell: run on meta -> count -> analyze
# --------------------------------------------------------------------------- #


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             lexi_budget_frac: Optional[float] = None,
             opts_kw: Optional[Dict] = None, out_dir: Optional[str] = None,
             verbose: bool = True, cfg_overrides: Optional[Dict] = None,
             tag: Optional[str] = None) -> Dict:
    shape = SHAPE_BY_NAME[shape_name]
    base_cfg = get_config(arch)
    skip = applicability(base_cfg, shape)
    mesh_desc = "2x16x16" if multi_pod else "16x16"
    record: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_desc}
    if tag:
        record["tag"] = tag

    if skip is not None:
        record.update(status="SKIP", reason=skip)
        _emit(record, out_dir, verbose)
        return record

    cfg = cell_config(base_cfg, shape, lexi_budget_frac)
    if cfg_overrides:
        cfg = cfg.with_(**cfg_overrides)
    opts = cell_opts(cfg, shape, **(opts_kw or {}))
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        heavy = heaviest_model_rank(cfg, mesh)
        best = None
        for rank in sorted({0, heavy}):
            t_rank = time.time()
            counts, param_bytes = run_rank(cfg, shape, mesh.place(rank),
                                           opts)
            report = rl.analyze_costs(
                rl.costs_from_counters(counts), cfg, shape,
                chips=mesh.size, mesh_desc=mesh_desc,
                bytes_per_device=rl.device_memory(counts),
                note=f"rank {rank}: the eager per-rank program on meta "
                     "(analysis/counters.py)")
            record.setdefault("ranks", {})[str(rank)] = {
                "bound_time_s": report.bound_time,
                "param_bytes": param_bytes,
                "seconds": round(time.time() - t_rank, 1)}
            if best is None or report.bound_time > best[1].bound_time:
                best = (rank, report, counts, param_bytes)
            gc.collect()
        rank, report, counts, param_bytes = best
        record.update(
            status="OK", rank=rank, total_s=round(time.time() - t0, 1),
            roofline=report.to_json(), counts=counts.as_dict(),
            param_bytes=param_bytes,
            memory_analysis={
                "argument_size_in_bytes": counts.input_bytes,
                "temp_size_in_bytes": counts.peak_bytes - counts.input_bytes,
                "peak_bytes": counts.peak_bytes})
    except Exception as e:
        record.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    gc.collect()
    _emit(record, out_dir, verbose)
    return record


def _emit(record: Dict, out_dir: Optional[str], verbose: bool) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"__{record['tag']}" if record.get("tag") else ""
        name = f"{record['arch']}__{record['shape']}__{record['mesh']}{tag}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(record, f, indent=1)
    if verbose:
        if record["status"] == "OK":
            r = record["roofline"]
            print(f"[OK]   {record['arch']:24s} {record['shape']:12s} "
                  f"{record['mesh']:8s} dominant={r['dominant']:10s} "
                  f"t=({r['t_compute']:.3e},{r['t_memory']:.3e},"
                  f"{r['t_collective']:.3e})s "
                  f"useful={r['useful_flops_ratio']:.2f} "
                  f"peak={r['bytes_per_device'] / 1e9:.1f}GB "
                  f"run={record['total_s']}s", flush=True)
        elif record["status"] == "SKIP":
            print(f"[SKIP] {record['arch']:24s} {record['shape']:12s} "
                  f"{record['mesh']:8s} {record['reason'][:70]}", flush=True)
        else:
            print(f"[FAIL] {record['arch']:24s} {record['shape']:12s} "
                  f"{record['mesh']:8s} {record['error'][:120]}", flush=True)


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--all", action="store_true", help="all 40 cells")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--lexi-budget-frac", type=float, default=None,
                    help="apply a synthetic LExI plan at this budget fraction")
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--a2a-chunks", type=int, default=1)
    ap.add_argument("--flash", action="store_true",
                    help="serving cells attend through B2 (prefill) / B8 "
                         "(decode)")
    ap.add_argument("--no-mla-absorb", action="store_true")
    ap.add_argument("--out", default=None, help="JSON output dir")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ASSIGNED)
    shapes = [args.shape] if args.shape else [s.name for s in SHAPES]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    opts_kw = dict(remat=args.remat, a2a_chunks=args.a2a_chunks,
                   use_flash=args.flash, mla_absorb=not args.no_mla_absorb)

    n_fail = 0
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, multi_pod=mp,
                               lexi_budget_frac=args.lexi_budget_frac,
                               opts_kw=opts_kw, out_dir=args.out)
                n_fail += rec["status"] == "FAIL"
    print(f"\ndone; {n_fail} failures; {time.time() - t0:.1f} s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
