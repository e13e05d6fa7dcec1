"""The paper's Fig. 4 comparison on the card: the full-model forward
(``loss_fn``) of the baseline, a LExI plan, the inter / intra pruning
baselines and NAEE dynamic skipping -- median forward ms over interleaved
repeats, and the cross-entropy of each.  The throughput side of
``benchmarks/bench_lexi_vs_pruning.py``; its quality side needs the
model's real weights (random weights, drawn from ``--seed``, only show the
path ran).

    PYTHONPATH=src python -m repro_torch.launch.forward --arch olmoe-1b-7b \
        --batch 4 --seq 512 --lexi-budget-frac 0.5 --prune-frac 0.25 \
        --skip-tau 0.3

    # the plain PyTorch path on the CPU, at test size
    PYTHONPATH=src python -m repro_torch.launch.forward --arch olmoe-1b-7b \
        --reduced --device cpu --batch 2 --seq 64 --lexi-budget-frac 0.5

    # DeepSeek-V2-Lite (MLA, a dense first layer, shared experts)
    PYTHONPATH=src python -m repro_torch.launch.forward \
        --arch deepseek-v2-lite --reduced --device cpu --batch 2 --seq 64

    # then trace one forward of each model: baseline and plan on the
    # config's own impl and on gmm (a graph replay; --eager traces the
    # eager forward)
    PYTHONPATH=src python -m repro_torch.launch.forward --arch olmoe-1b-7b \
        --profile

Every model runs the config's own MoE dispatch, the capacity-buffer
``dense`` impl (``moe_ffn``); the baseline and the plan run again on the
dropless ``gmm`` dispatch (``moe_gmm``), as the reference benchmark's
``fig4/<name>~gmm`` rows: capacity drops change the dense numbers of a
reduced-k plan.  The ``dyn_skip_tau<tau>`` row is the baseline's weights
with ``with_dynamic_skipping`` (``--skip-tau``; 0 leaves it out): its skip
decision is data-dependent and its shapes static, so its forward should
cost what the baseline's does; the row carries ``expected_skip_rate``, the
mean over the MoE layers of each layer's Monte-Carlo skip share.
Attention runs ``flash_attention`` on a GQA model (an MLA model, ``--arch
deepseek-v2-lite``, attends through the plain masked softmax in train
mode, as the reference).  The plan is profiled on
``gmm``, as the reference's Alg. 1.  Each pruned copy of the experts is
built, timed in turns with the others, and freed before the next.

On the card each model's forward runs as a CUDA graph, the counterpart of
the reference's jitted ``loss_fn``: its untimed first call runs eagerly
and captures the graph, which every timed call replays on the fixed batch
(the cross-entropy is read after the replay).  ``--eager`` times the same
forwards eagerly, the oracle.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import apply_plan_params, expected_skip_rate, \
    inter_prune, intra_prune, iter_moe_layer_params, with_dynamic_skipping


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """Tokens and targets drawn with numpy from ``seed``; every position
    counts in the loss."""
    rng = np.random.default_rng(seed)
    out = {n: torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))
                               .astype(np.int32)).to(device)
           for n in ("tokens", "targets")}
    out["mask"] = torch.ones((batch, seq), device=device)
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Forward:
    """``loss_fn`` of one model on one batch -> its cross-entropy.  With
    ``graph`` = (capture stream, memory pool) the first call runs eagerly
    on the capture stream and captures a CUDA graph that every later call
    replays; the graph lives as long as this object."""

    def __init__(self, params, cfg: ModelConfig, batch, opts, graph=None):
        self.fn = lambda: models.loss_fn(params, cfg, batch,
                                         opts=opts)[1]["xent"]
        self.ctx = graph
        self.graph = None

    def __call__(self):
        if self.ctx is None:
            return self.fn()
        from repro_torch.kernels import _graphs
        if self.graph is None:
            stream, pool = self.ctx
            out = _graphs.on_stream(self.fn, stream)
            self.graph = _graphs.capture(self.fn, stream=stream, pool=pool)
            return out
        return self.graph.replay()


def graph_context(device, graphs: bool = True):
    """(capture stream, memory pool) for ``Forward`` on the card, None
    where the forwards run eagerly (``graphs=False``, or the CPU)."""
    if not graphs or torch.device(device).type != "cuda":
        return None
    return torch.cuda.Stream(device), torch.cuda.graph_pool_handle()


def compare(params, cfg: ModelConfig, plan, batch, *,
            prune_frac: float = 0.25, skip_tau: float = 0.3, reps: int = 5,
            opts: models.ModelOpts = models.ModelOpts(
                use_flash=True, use_moe_kernel=True),
            graphs: bool = True) -> Dict[str, Dict]:
    """Forward ms (each call ended by a device sync) and cross-entropy of
    the baseline, ``plan``, both pruning baselines at ``prune_frac`` and
    dynamic skipping at ``skip_tau`` (where top-k >= 2 and ``skip_tau`` >
    0; its row adds ``expected_skip_rate``) on ``cfg.moe_impl``, and --
    unless that is ``gmm`` -- of the baseline and ``plan`` on ``gmm`` too
    (``baseline~gmm``, ``lexi~gmm``): per model the median, every timed
    call, and the MoE shape and impl it ran.  On the
    card each model's forward is a CUDA graph (``Forward``), captured by
    its untimed warm-up call and freed with the model; ``graphs=False``
    times them eagerly."""
    device = batch["tokens"].device
    ctx = graph_context(device, graphs)
    cfg_l, params_l = apply_plan_params(params, cfg, plan)
    live = {"baseline": (params, cfg), "lexi": (params_l, cfg_l)}
    if cfg.moe_impl != "gmm":
        live["baseline~gmm"] = (params, cfg.with_(moe_impl="gmm"))
        live["lexi~gmm"] = (params_l, cfg_l.with_(moe_impl="gmm"))
    skip = {}
    if skip_tau > 0 and cfg.moe_top_k >= 2:
        name = f"dyn_skip_tau{skip_tau:g}"
        live[name] = (params, with_dynamic_skipping(cfg, skip_tau))
        rates = [expected_skip_rate(mp, cfg, skip_tau)
                 for _, mp in iter_moe_layer_params(params, cfg)]
        skip[name] = {"expected_skip_rate": float(np.mean(rates)),
                      "tau": skip_tau}
    live = {n: (p, c, Forward(p, c, batch, opts, ctx))
            for n, (p, c) in live.items()}
    every = list(live)
    times: Dict[str, list] = {}
    out: Dict[str, Dict] = {}

    def run(name: str, timed: bool = True) -> None:
        p, c, fwd = live[name]
        _sync(device)
        t0 = time.perf_counter()
        xent = fwd()
        _sync(device)
        if timed:
            times.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
        out[name] = {"xent": xent.item(), "graphed": ctx is not None,
                     "moe_impl": c.moe_impl,
                     "experts": c.num_experts,
                     "moe_d_ff": c.moe_d_ff,
                     "mean_top_k": float(np.mean([
                         s.moe_top_k for s in c.pattern()
                         if s.kind == "attn_moe"]))}

    for name, prune in ((f"inter_prune_{prune_frac:g}", inter_prune),
                        (f"intra_prune_{prune_frac:g}", intra_prune)):
        p, c = prune(params, cfg, prune_frac)
        live[name] = (p, c, Forward(p, c, batch, opts, ctx))
        del p
        names = every + [name]
        for n in names:                                 # warm-up
            run(n, timed=False)
        for r in range(reps):
            for n in (names if r % 2 == 0 else names[::-1]):
                run(n)
        del live[name]
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for name, rec in out.items():
        rec["ms_median"] = statistics.median(times[name])
        rec["ms"] = times[name]
        rec.update(skip.get(name, {}))
    return out


def main(argv=None) -> int:
    from repro_torch.launch.serve import _device_breakdown, _profiled
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lexi-budget-frac", type=float, default=0.5,
                    help="active-expert budget of the plan searched inline")
    ap.add_argument("--prune-frac", type=float, default=0.25)
    ap.add_argument("--skip-tau", type=float, default=0.3,
                    help="NAEE dynamic-skipping threshold of the "
                         "dyn_skip_tau<tau> row (0 leaves the row out)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", action="store_true",
                    help="then trace one forward of the baseline and the "
                         "plan, on the config's own impl and on gmm, with "
                         "torch.profiler and print device time by kernel")
    ap.add_argument("--eager", action="store_true",
                    help="run the forwards eagerly on the card (the oracle "
                         "the CUDA graphs are held to)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.core import optimize
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = models.init_params(cfg, args.seed, device=args.device)
    device = params["embed"].device
    opts = models.ModelOpts(use_flash=True, use_moe_kernel=True)
    n = cfg.num_moe_layers
    budget = max(n, int(round(args.lexi_budget_frac * n * cfg.moe_top_k)))
    plan = optimize(params, cfg, budget, method="dp", n_iter=4,
                    profile_batch=2, profile_seq=32, seed=args.seed,
                    device=device, use_kernel=True)
    batch = make_batch(cfg, args.batch, args.seq, args.seed, device)
    res = compare(params, cfg, plan, batch, prune_frac=args.prune_frac,
                  skip_tau=args.skip_tau, reps=args.reps, opts=opts,
                  graphs=not args.eager)
    print(json.dumps({"arch": cfg.name, "device": str(device),
                      "batch": [args.batch, args.seq], "plan": plan.plan,
                      "budget": budget, "graphs": not args.eager,
                      "models": res}))
    if args.profile:
        cfg_l, params_l = apply_plan_params(params, cfg, plan)
        variants = {"baseline": (params, cfg), "lexi": (params_l, cfg_l)}
        if cfg.moe_impl != "gmm":
            variants["baseline~gmm"] = (params, cfg.with_(moe_impl="gmm"))
            variants["lexi~gmm"] = (params_l, cfg_l.with_(moe_impl="gmm"))
        ctx = graph_context(device, not args.eager)
        for name, (p, c) in variants.items():
            wall = {}
            fwd = Forward(p, c, batch, opts, ctx)
            fwd()                       # builds, warms up, captures
            _sync(device)

            def traced(fwd=fwd):
                t0 = time.perf_counter()
                fwd()
                _sync(device)
                wall["s"] = time.perf_counter() - t0

            _, prof = _profiled(traced, True)
            _device_breakdown(f"forward_{name}", prof, wall["s"])
            del fwd
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
