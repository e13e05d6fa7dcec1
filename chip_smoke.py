#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. build   -- compile every CUDA kernel of ``src/repro_torch/csrc`` (one
              ``nvcc`` per source, all started together) into ``build/``;
              the build line carries ptxas's registers / spills report of
              every kernel.
2. kernels -- hold each kernel against its plain PyTorch version in bf16 at
              the shapes the main paths give it (``moe_gmm`` also at the
              edges of its tiling -- row tiles of 8, 40 and 128 rows, F
              1056, dead tiles, an expert with no rows -- with its host
              microseconds a call, and timed beside the library's grouped
              GEMM, SwiGLU, grouped GEMM; ``flash_attention`` also at hd
              64, a ragged S of 37 and 200 and strided [B, S, H, hd]
              views, and at one GQA shape with a sliding window;
              ``flash_decode`` also at GQA g=4 under a window over a
              wrapped ring, on one row of 512 positions and on rows at the
              edges of its 32-slot chunks, each row of the check and the
              GQA shape held bit for bit alone against the batch;
              ``flash_decode_paged`` also at GQA g=4 under a window, on one
              row of 512 positions and on rows ending one page past a
              chunk boundary, ``flash_decode_paged_mla`` also on one row
              of 512 positions, each held bit for bit row by row: a row
              alone at its own live-page width against the batch at a
              64-column table view;
              the attention kernels, ``moe_ffn``, ``moe_decode`` and the
              quantized expert kernels, in int8 and int4, row by row, to
              ROW_TOL;
              ``moe_ffn`` on capacity buffers dispatched by the model's
              router at the forward, chunk and decode shapes;
              ``moe_decode`` on 8 tokens at top-k and at k 2, each shape
              with its distinct routed experts and the bytes they make),
              and time both with CUDA events (per-call medians of device
              time, L2 flushed before every call, kernel, plain and -- where
              one PyTorch call computes the same function -- that call
              interleaved).
3. serve   -- OLMoE-1B-7B at full width and depth (16 layers, d 2048, 64
              experts, top-8), bf16, random weights drawn on the card from a
              seed: serve 8 requests on the paged pool with chunked
              prefill (a warm-up wave of the same requests first, so the
              measured serve replays a graph for every step), search a
              LExI plan on the card (Alg. 1 through the ``moe_gmm`` kernel,
              then the DP search), register it and serve again (after a
              wave that captures the plan's keys); each serve again on an
              eager engine (equal greedy tokens, equal launch counts);
              then ``serve_mixed``: the same 8 requests, alternating base
              and the plan, in one wave through the bucketed-k mixed-plan
              steps, twice (the first captures the bucket keys) -- each
              request's tokens equal its single-plan serve's.
3b. serve_prefix -- 16 requests on one 192-token head (12 full pages, 3
              whole chunks), 14 with a suffix of 1-15 tokens and two whose
              prompt is the head, served with the prefix cache off, then
              cold and warm on one engine with it on: the aligned hits'
              tokens equal in all three, the head-only requests' hits (191,
              through a copy-on-write) give first-token logits rows within
              ROW_TOL of the cache-off rows; the warm serve captures no
              graph, copies 2 pages and its host counts (hits, copies,
              prefill) equal the CPU rehearsal's (PREFIX_COUNTS); an eager
              twin of it; a serve on a PRESSURE_PAGES pool that preempts
              and evicts, with its eager twin; the pool drained after
              each; then the copy-on-write device check (a copied page bit
              for bit in every leaf, ``posp`` masked past ``keep_below``).
3c. serve_ladder -- 16 requests asking for base under the ladder base ->
              lexi with ``degrade_under_pressure``: each request's tokens
              equal its served plan's single-plan serve's; an eager twin.
3d. serve_open_loop -- the 16 requests arriving at steps 0, 2, 4, ... on a
              VirtualClock: tokens equal the closed-loop serve's and the
              eager twin's; TTFT p50 / p95 in steps.
3e. api_server check -- an ``ApiServer`` over the paged engine, the plan
              registered as "lexi": four completions one at a time (base
              and lexi, streamed and blocking) equal, in tokens and text,
              the same engine's solo ``serve([req], detok=True)``; eight
              client threads at once (mixed plans, priorities, streams):
              every stream's deltas make its text, the text is the detok
              of the tokens, the plan is as asked, and the count of
              results equal to their solo serves is printed with the first
              differing position of any other; ``/v1/stats`` finite while
              they run; a client gone mid-stream returns every page and
              the uid and the next completion equals its solo serve; the
              engine handed back drained.  TTFT p50 / p95, a decode step's
              wall and host ms behind the server, the pump's captures.
3f. serve_lookahead -- serve's 8 requests with ``router_lookahead=True``
              against it off, bf16 (``moe_decode``) and int8
              (``moe_decode_quant``, ``moe_gmm_quant``): equal tokens,
              every live decode logits row bitwise equal, equal launches;
              the decode step's ms on and off, timed in turns.
3g. api_server -- the port's server entry point
              (``repro_torch.launch.api_server.main``, ``--smoke``) in
              this process at full width over a localhost socket, with
              every kernel's plain version forbidden on the card: the
              kernel options on, ``moe_decode`` and ``flash_decode_paged``
              once a layer in every decode step, ``moe_gmm`` launched, and
              the engine and its weights freed when ``main`` returns.
4. forward -- the paper's Fig. 4 comparison at full width: ``loss_fn``
              through ``flash_attention`` and the config's own ``dense``
              MoE (``moe_ffn``) on 4 x 512 tokens for the baseline, the
              LExI plan (``apply_plan_params``), and the ``inter_prune`` /
              ``intra_prune`` baselines at 0.25 (each pruned copy freed
              before the next is built), NAEE dynamic skipping at tau 0.3
              (``dyn_skip``: its ms against the baseline's and its
              expected skip rate), and the baseline and the plan on
              ``gmm`` (``moe_gmm``) too; median forward ms over interleaved
              repeats, and the cross-entropy of each; each forward a CUDA
              graph, then the same forwards eagerly (their medians beside).
5. serve_contiguous -- the same 8 requests, baseline and LExI plan, through
              the contiguous layout with whole-prompt prefill
              (``flash_attention``, ``moe_gmm``) and decode
              (``flash_decode``, ``moe_decode``).
5b. serve_contiguous_chunked -- the same requests on the contiguous layout
              with chunked prefill (chunk 64): the chunk steps replay a
              CUDA graph, ``flash_attention`` never launches, tokens equal
              the eager twin's, first-token logits rows within ROW_TOL of
              the paged serve's.
6. serve_quant -- the same 8 requests on the paged pool with the routed
              experts quantized at load, ``Engine(expert_dtype="int8")``
              and then ``"int4"``, baseline and LExI plan each: every step
              must launch ``moe_gmm_quant``, ``moe_decode_quant`` and
              ``flash_decode_paged``, and neither bf16 expert kernel.
7. serve_dense -- the same 8 requests on the paged pool through the
              config's own ``dense`` impl (``moe_ffn``, 16 launches a chunk
              and a decode step; ``flash_decode_paged``), baseline and LExI
              plan: no ``moe_gmm`` and no ``moe_decode`` may launch; the
              copies the capacity buffers dropped are counted on the card
              (in counters every graph adds to at each replay).
8. serve_mla -- the OLMoE weights freed, DeepSeek-V2-Lite at full width and
              depth (27 layers, MLA with kv_lora_rank 512, a dense first
              layer, 64 experts top-6 plus 2 shared), bf16, random weights
              drawn on the card: ``moe_gmm``, ``moe_decode`` and ``moe_ffn``
              held against their plain versions at its expert shapes (and
              the intra-pruned F 1056, with the quantized kernels), the
              kernel paths' logits against the plain paths' (``gmm`` and
              ``dense``), then the same 8 requests on
              the paged pool (``flash_decode_paged_mla``, 27 launches a
              decode step, ``moe_gmm``, ``moe_decode``; no GQA attention
              kernel), the prefix workload with the cache off and warm
              (the aligned hits' tokens equal, ``flash_decode_paged_mla``
              still 27 launches a decode step), a LExI plan searched on
              the card at budget 0.5 x 26 x 6 and served, and the
              baseline again on the
              contiguous layout with whole-prompt prefill (``moe_gmm``,
              ``moe_decode``; no attention kernel: MLA's contiguous decode
              is plain PyTorch, as in the reference).
9. forward_mla -- phase 4 on DeepSeek-V2-Lite (``moe_ffn`` and
              ``moe_gmm``; MLA's train mode attends through the plain
              masked softmax).

Every serve and forward runs its steps as CUDA graphs, captured for each
specialization key of the runner (``serving/runner.py``) or each forward
(``launch/forward.py``) and replayed; a replay adds the launches its
capture recorded to the wrappers' counts, so the counts are the launches
the card ran.  The paged baseline and plan serves, the contiguous, dense
and MLA paged baselines run once more on an eager engine, the oracle:
greedy tokens and launch counts must be equal.  Each serve's line carries
wall time, tok/s, the wall and host time of a decode step, and the graphs
held, captured (with their host seconds) and replayed.

Every kernel's launch counter is zeroed just before and read just after
each step of phases 3-9; each step must launch the kernels it runs.  A
small reference check holds the kernel paths' logits against the plain
paths' on the same inputs, row by row, with bf16 experts on ``gmm`` and
on ``dense``, with int8 and int4 experts, and on DeepSeek-V2-Lite.  Then
it prints the
``kernels`` summary line (launches summed over every step), the card's
name and power limit, and as the last line ``{"ok": true, "device":
{...}}``.  Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import replace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16
#: FLOP/s on the tensor cores, f32 FLOP/s outside them
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
#: an expert kernel passes when max |kernel - plain| <= TOL * max |plain|:
#: both accumulate in f32 in different orders and round the output to bf16
#: (relative step 2^-8), and moe_gmm also rounds its hidden to bf16
TOL = 2e-2
#: an attention kernel, or an expert kernel held row by row (moe_ffn,
#: moe_decode, the quantized ones), passes when every output row (one
#: query head's hd values, one token's output) has ||kernel - plain|| <=
#: ROW_TOL * ||plain||.  Rows differ in
#: scale by the number of keys they see (a row over n random keys has
#: norm ~ 1/sqrt(n) of one over a single key), so a bound on the largest
#: value would let the long rows be wrong; bf16 rounding of P and of the
#: output leaves about 3e-3 per row, while one key too many or too few in
#: a row over n keys moves it by about 1/sqrt(n) (0.04 at n = 512)
ROW_TOL = 1e-2
#: the model's logits on the kernel and the plain paths: the same per-row
#: relative error (one row = one token's logits)
LOGITS_TOL = 3e-2
FLUSH_BYTES = 128 << 20           # > the 50 MB L2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# --------------------------------------------------------------------------- #
# timing
# --------------------------------------------------------------------------- #


#: GPU cycles to spin before the start event, so the host has enqueued the
#: timed call (wrapper checks, allocation, every op of a plain version)
#: before the GPU reaches it and the events time device work only
SPIN_CYCLES = 4_000_000


def _time_once(fn, flush) -> float:
    flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_calls(fns, flush, reps: int = 15):
    """Median per-call device ms of each of ``fns``, interleaved (the order
    rotates every repeat) after one warm-up of each; the L2 is flushed
    before every call."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for r in range(reps):
        for i in range(len(fns)):
            j = (i + r) % len(fns)
            times[j].append(_time_once(fns[j], flush))
    return [statistics.median(t) for t in times]


def compare(name: str, got: torch.Tensor, want: torch.Tensor, **extra):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rec = {"check": name, "max_abs_err": err, "max_abs_ref": scale,
           "rel_err": err / max(scale, 1e-30), "tol": TOL, **extra}
    emit(rec)
    if err > TOL * scale:
        raise AssertionError(f"{name}: max abs err {err} > {TOL} x {scale}")
    return err


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """||got - want|| / ||want|| of each row along the last dim; a zero
    row of ``want`` must come out exactly zero (else the error is inf)."""
    got, want = got.float(), want.float()
    e = (got - want).norm(dim=-1).flatten()
    w = want.norm(dim=-1).flatten()
    return torch.where(w > 0, e / w.clamp(min=1e-30),
                       torch.where(e > 0, float("inf"), 0.0))


def compare_rows(name: str, got: torch.Tensor, want: torch.Tensor, **extra):
    """Hold an attention kernel's output to ROW_TOL row by row; returns
    the largest absolute difference for the ``kernels`` line."""
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    rel = row_rel_err(got, want)
    rec = {"check": name,
           "max_abs_err": (got.float() - want.float()).abs().max().item(),
           "max_row_rel_err": rel.max().item(),
           "median_row_rel_err": rel.median().item(), "tol": ROW_TOL,
           **extra}
    emit(rec)
    if rec["max_row_rel_err"] > ROW_TOL:
        raise AssertionError(f"{name}: a row's relative error "
                             f"{rec['max_row_rel_err']} > {ROW_TOL}")
    return rec["max_abs_err"]


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #


def check_moe_gmm(layer, cfg, x, flush, tag: str = ""):
    """B1 on the model's routing of ``x``, held to TOL; timed against its
    plain version and, where the card's torch computes it, the library's
    form of B1's function (library_ms): the rows of the plan's valid tiles,
    grouped by expert (offsets from ``tile_expert`` / ``tile_valid``),
    through ``torch._grouped_mm`` (up, [E, D, 2F]), SwiGLU, then
    ``torch._grouped_mm`` (down), held row by row to ROW_TOL first (the
    rows past them are dead tiles, which B1 writes as zeros); else
    library_ms is null and the row says why."""
    import torch.nn.functional as F_
    from repro_torch.kernels import moe_gmm
    from repro_torch.kernels.moe_gmm import moe_gmm_plain
    from repro_torch.models.moe import default_block_m, make_sort_plan, \
        route, sort_dispatch
    k = cfg.moe_top_k
    _, idx, _ = route(layer, cfg, x, k)
    plan = make_sort_plan(idx, cfg.num_experts,
                          default_block_m(x.shape[0] * k, floor=8))
    xs = sort_dispatch(x, plan, k)
    args = (xs, layer["w1"], layer["w2"], plan.tile_expert, plan.tile_valid)
    got = moe_gmm(*args, block_m=plan.block_m)
    want = moe_gmm_plain(*args, plan.block_m)
    valid = int(plan.tile_valid.sum())
    experts = int(torch.unique(plan.tile_expert[plan.tile_valid.bool()]).numel())
    err = compare(f"moe_gmm{tag}", got, want, tokens=x.shape[0], k=k,
                  f=cfg.moe_d_ff,
                  block_m=plan.block_m, tiles=len(plan.tile_valid),
                  valid_tiles=valid, experts=experts)
    fns = [lambda: moe_gmm(*args, block_m=plan.block_m),
           lambda: moe_gmm_plain(*args, plan.block_m)]
    extra = {"library": "torch._grouped_mm, SwiGLU, torch._grouped_mm"}
    w1, w2, f = layer["w1"], layer["w2"], cfg.moe_d_ff
    valid_e = plan.tile_expert[plan.tile_valid.bool()].long()
    offs = torch.cumsum(torch.bincount(valid_e, minlength=cfg.num_experts)
                        * plan.block_m, 0).to(torch.int32)
    live = int(offs[-1])

    def library():
        h = torch._grouped_mm(xs[:live], w1, offs=offs)
        return torch._grouped_mm(F_.silu(h[:, :f]) * h[:, f:], w2, offs=offs)

    try:
        compare_rows(f"moe_gmm{tag}_grouped_mm", library(), want[:live],
                     rows=live)
        fns.append(library)
    except (AttributeError, RuntimeError, AssertionError, ValueError) as e:
        extra["library_error"] = f"{type(e).__name__}: {e}"[:300]
        emit({"check": f"moe_gmm{tag}_grouped_mm",
              "error": extra["library_error"]})
    ms, plain_ms, *lib = time_calls(fns, flush)
    emit({"check": f"moe_gmm{tag}_host", "ms": ms,
          "host_us_per_call": host_us(
              lambda: moe_gmm(*args, block_m=plan.block_m))})
    d, f = cfg.d_model, cfg.moe_d_ff
    rows = x.shape[0] * k                      # real token copies
    nbytes = (2 * rows * d * 2                  # real rows in, out
              + experts * 3 * d * f * 2         # routed experts' weights
              + 2 * 4 * len(plan.tile_valid))
    flops = rows * 6 * d * f
    return (err, ms, plain_ms, nbytes, flops, lib[0] if lib else None,
            extra)


def check_moe_gmm_edges(layer, cfg, x):
    """B1 at the edges of its tiling, at the model's width (D 2048): row
    tiles of 8 and 40 rows (one warpgroup, most of its rows past the tile)
    and of 128 (two), each plan with dead tiles and an expert that gets no
    row (its copies sent to the next expert), and F 1056 (a part-filled
    last column box) on random experts; held to TOL, dead tiles exactly
    zero.  Returns the largest error."""
    from repro_torch.kernels import moe_gmm
    from repro_torch.kernels.moe_gmm import moe_gmm_plain
    from repro_torch.models.moe import make_sort_plan, route, sort_dispatch
    k, e, d = cfg.moe_top_k, cfg.num_experts, cfg.d_model
    gen = torch.Generator(device=x.device)
    gen.manual_seed(9)
    w1056 = [(torch.randn(shape, generator=gen, device=x.device) * 0.02)
             .to(torch.bfloat16) for shape in ((16, d, 2 * 1056),
                                               (16, 1056, d))]
    err = 0.0
    for tokens, bm, f in ((5, 8, 1024), (37, 40, 1024), (512, 128, 1024),
                          (37, 40, 1056), (200, 128, 1056)):
        xx = x[:tokens].contiguous()
        if f == 1024:
            w1, w2 = layer["w1"], layer["w2"]
            _, idx, _ = route(layer, cfg, xx, k)
        else:
            w1, w2 = w1056
            idx = torch.randint(0, 16, (tokens, k), generator=gen,
                                device=x.device)
        n_e = w1.shape[0]
        empty = int(idx[0, 0])                  # routed, then emptied
        idx = torch.where(idx == empty, (empty + 1) % n_e, idx).int()
        plan = make_sort_plan(idx, n_e, bm)
        args = (sort_dispatch(xx, plan, k), w1, w2, plan.tile_expert,
                plan.tile_valid)
        got = moe_gmm(*args, block_m=bm)
        dead = ~plan.tile_valid.bool()
        if not dead.any() or (plan.tile_expert[plan.tile_valid.bool()]
                              == empty).any():
            raise AssertionError(f"moe_gmm edge plan bm {bm}: no dead tile "
                                 "or the emptied expert has rows")
        if (got.reshape(-1, bm, d)[dead] != 0).any():
            raise AssertionError(f"moe_gmm edge bm {bm}: a dead tile is "
                                 "not zero")
        err = max(err, compare(
            f"moe_gmm_edge_bm{bm}_f{f}", got,
            moe_gmm_plain(*args, bm), tokens=tokens, k=k, experts=n_e,
            tiles=len(plan.tile_valid), dead_tiles=int(dead.sum()),
            empty_expert=empty))
    return err


def host_us(fn, n: int = 50) -> float:
    """Median host microseconds of one call of ``fn`` (wrapper checks,
    tensor maps, launch), the device left to run behind it."""
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def check_moe_decode(layer, cfg, x, flush, tag: str = ""):
    """B3 on ``x``'s routing by the layer's router at top-k and at k 2,
    each held row by row (one token's output a row) to ROW_TOL and timed
    against the plain version.  Returns
    {"k<k>": (err, ms, plain_ms, nbytes, flops, None, extra)}: the bytes
    count each distinct routed expert once, as the kernel reads it; extra
    holds that count and those bytes."""
    from repro_torch.kernels import moe_decode
    from repro_torch.kernels.moe_decode import moe_decode_plain
    from repro_torch.models.moe import route
    d, f = cfg.d_model, cfg.moe_d_ff
    out = {}
    for k in (cfg.moe_top_k, 2):
        weights, idx, _ = route(layer, cfg, x, k)
        args = (x, layer["w1"], layer["w2"], idx, weights)
        experts = int(torch.unique(idx).numel())
        err = compare_rows(f"moe_decode{tag}_k{k}", moe_decode(*args),
                           moe_decode_plain(*args), batch=x.shape[0], k=k,
                           experts=experts)
        ms, plain_ms = time_calls((lambda: moe_decode(*args),
                                   lambda: moe_decode_plain(*args)), flush)
        b = x.shape[0]
        nbytes = experts * 3 * d * f * 2 + 2 * b * d * 2 + b * k * 8
        out[f"k{k}"] = (err, ms, plain_ms, nbytes, b * k * 6 * d * f, None,
                        {"experts": experts, "bytes": nbytes})
    return out


def _quant_bytes(experts, d, f, dtype):
    """Bytes of ``experts`` quantized experts: int8 (int4: two a byte)
    weights plus their f32 scale rows (s1 [2, F], s2 [F])."""
    per = 3 * d * f if dtype == "int8" else 3 * d * f // 2
    return experts * (per + 3 * f * 4)


def varied_experts(layer, seed: int = 6):
    """``layer`` with its experts' channels scaled apart (w1 per column, w2
    per f-row, by factors e^N(0, 1/4)), so that their quantization scales
    differ.  ``dense_init`` clamps every weight at two standard deviations,
    so each channel's absmax is the clamp and all scales of the model's
    own layers come out equal: a scale row read for the wrong channel, or
    s2 applied at the wrong place, would not show on them."""
    w1, w2 = layer["w1"], layer["w2"]
    g = torch.Generator(device=w1.device)
    g.manual_seed(seed)
    e, _, twof = w1.shape
    f = w2.shape[1]
    c1 = torch.exp(0.5 * torch.randn((e, 1, twof), generator=g,
                                     device=w1.device))
    c2 = torch.exp(0.5 * torch.randn((e, f, 1), generator=g,
                                     device=w1.device))
    return dict(layer, w1=(w1.float() * c1).to(w1.dtype),
                w2=(w2.float() * c2).to(w2.dtype))


def check_moe_gmm_quant(layer, cfg, x, flush, tag: str = ""):
    """B6 in int8 and int4 on layer 0's experts (channels scaled apart,
    ``varied_experts``) quantized on the card, at the prefill shape (512
    tokens x top-k); returns a kernels-line row's numbers per dtype, with
    B1 (``moe_gmm``, bf16) on the same routing and the same scaled experts
    timed in the same turns as its yardstick (``sibling_ms``): the same
    products on 2x (int8) or 4x (int4) the weight bytes."""
    from repro_torch.kernels import moe_gmm, moe_gmm_quant
    from repro_torch.kernels.moe_gmm import moe_gmm_quant_plain
    from repro_torch.models.moe import QUANT_DTYPES, default_block_m, \
        make_sort_plan, quantize_moe_layer, route, sort_dispatch
    k = cfg.moe_top_k
    _, idx, _ = route(layer, cfg, x, k)
    plan = make_sort_plan(idx, cfg.num_experts,
                          default_block_m(x.shape[0] * k, floor=8))
    xs = sort_dispatch(x, plan, k)
    live = plan.tile_expert[plan.tile_valid.bool()]
    experts = int(torch.unique(live).numel())
    d, f = cfg.d_model, cfg.moe_d_ff
    rows = x.shape[0] * k
    varied = varied_experts(layer)
    bf16_args = (xs, varied["w1"], varied["w2"], plan.tile_expert,
                 plan.tile_valid)
    out = {}
    for dt in QUANT_DTYPES:
        q = quantize_moe_layer(varied, dt)
        args = (xs, q["w1"], q["w2"], q["w1_scale"], q["w2_scale"],
                plan.tile_expert, plan.tile_valid)
        err = compare_rows(f"moe_gmm_quant{tag}_{dt}",
                           moe_gmm_quant(*args, dtype=dt,
                                         block_m=plan.block_m),
                           moe_gmm_quant_plain(*args, plan.block_m, dtype=dt),
                           tokens=x.shape[0], k=k, block_m=plan.block_m,
                           tiles=len(plan.tile_valid),
                           live_tiles=int(plan.tile_valid.sum()),
                           experts=experts)
        ms, plain_ms, sib_ms = time_calls(
            (lambda: moe_gmm_quant(*args, dtype=dt, block_m=plan.block_m),
             lambda: moe_gmm_quant_plain(*args, plan.block_m, dtype=dt),
             lambda: moe_gmm(*bf16_args, block_m=plan.block_m)), flush)
        nbytes = (2 * rows * d * 2 + _quant_bytes(experts, d, f, dt)
                  + 2 * 4 * len(plan.tile_valid))
        out[dt] = (err, ms, plain_ms, nbytes, rows * 6 * d * f, None,
                   {"sibling_ms": sib_ms})
        del q, args
    return out


def check_moe_decode_quant(layer, cfg, x, flush, tag: str = "", ks=None):
    """B5 in int8 and int4 at the decode shape (``x``'s tokens routed by
    the layer's router at each k of ``ks``, default top-k alone) on the
    same varied experts, one router weight set to zero (route()'s k_budget
    relies on a zero-weight slot adding exactly nothing); B3
    (``moe_decode``, bf16) on the same routing timed in the same turns as
    its yardstick (``sibling_ms``).  Keys: the dtype at top-k, else
    ``<dtype>_k<k>``; the bytes count each distinct routed expert once."""
    from repro_torch.kernels import moe_decode, moe_decode_quant
    from repro_torch.kernels.moe_decode import moe_decode_quant_plain
    from repro_torch.models.moe import QUANT_DTYPES, quantize_moe_layer, \
        route
    d, f = cfg.d_model, cfg.moe_d_ff
    b = x.shape[0]
    varied = varied_experts(layer)
    qs = {dt: quantize_moe_layer(varied, dt) for dt in QUANT_DTYPES}
    out = {}
    for k in ks or (cfg.moe_top_k,):
        weights, idx, _ = route(layer, cfg, x, k)
        weights = weights.clone()
        weights[0, -1] = 0.0
        experts = int(torch.unique(idx).numel())
        bf16_args = (x, varied["w1"], varied["w2"], idx, weights)
        for dt, q in qs.items():
            key = dt if k == cfg.moe_top_k else f"{dt}_k{k}"
            args = (x, q["w1"], q["w2"], q["w1_scale"], q["w2_scale"], idx,
                    weights)
            err = compare_rows(f"moe_decode_quant{tag}_{key}",
                               moe_decode_quant(*args, dtype=dt),
                               moe_decode_quant_plain(*args, dtype=dt),
                               batch=b, k=k, experts=experts)
            ms, plain_ms, sib_ms = time_calls(
                (lambda: moe_decode_quant(*args, dtype=dt),
                 lambda: moe_decode_quant_plain(*args, dtype=dt),
                 lambda: moe_decode(*bf16_args)), flush)
            nbytes = (_quant_bytes(experts, d, f, dt) + 2 * b * d * 2
                      + b * k * 8)
            out[key] = (err, ms, plain_ms, nbytes, b * k * 6 * d * f, None,
                        {"sibling_ms": sib_ms, "experts": experts,
                         "bytes": nbytes})
    return out


def capacity_buffers(layer, cfg, x):
    """xe [E, C, D]: ``x``'s token copies dispatched by the layer's own
    router into capacity buffers, as ``moe_dense`` builds them."""
    from repro_torch.models.moe import capacity, route
    from repro_torch.models.moe.dispatch import _scatter, _slot_positions
    k, e = cfg.moe_top_k, cfg.num_experts
    _, idx, _ = route(layer, cfg, x, k)
    cap = capacity(x.shape[0], k, e, cfg.moe_capacity_factor)
    pos, keep = _slot_positions(idx, e, cap)
    return _scatter(x, idx, pos, keep, e, cap), int((~keep).sum())


def check_moe_ffn(layer, cfg, x, flush, tag: str):
    """B9 on ``x``'s capacity buffers (``capacity_buffers``) and the
    layer's experts scaled apart per channel (``varied_experts``), held row
    by row; timed against the plain version and the library's bf16
    ``bmm`` -> SwiGLU -> ``bmm`` (two cuBLAS calls and the elementwise
    ops between them, not one call).  Every expert's weights and every
    buffer row are read, whatever the routing."""
    import torch.nn.functional as F_
    from repro_torch.kernels import moe_ffn
    from repro_torch.kernels.moe_ffn import moe_ffn_plain
    xe, dropped = capacity_buffers(layer, cfg, x)
    varied = varied_experts(layer)
    w1, w2 = varied["w1"], varied["w2"]
    e, c, d = xe.shape
    f = w2.shape[1]
    err = compare_rows(f"moe_ffn_{tag}", moe_ffn(xe, w1, w2),
                       moe_ffn_plain(xe, w1, w2), tokens=x.shape[0],
                       k=cfg.moe_top_k, capacity=c, f=f,
                       dropped_copies=dropped)

    def library():
        h = torch.bmm(xe, w1)
        return torch.bmm(F_.silu(h[..., :f]) * h[..., f:], w2)

    ms, plain_ms, lib_ms = time_calls(
        (lambda: moe_ffn(xe, w1, w2), lambda: moe_ffn_plain(xe, w1, w2),
         library), flush)
    nbytes = e * 3 * d * f * 2 + 2 * e * c * d * 2
    flops = e * c * 6 * d * f
    return err, ms, plain_ms, nbytes, flops, lib_ms


def paged_positions(lens, n, p, n_blk, device):
    """posp [n, p], block table [B, n_blk] and cur_pos [B] as the engine
    leaves them: row r holds positions 0..lens[r]-1 in its first pages,
    unmapped table entries point at trash page 0 (posp -1)."""
    posp = torch.full((n, p), -1, dtype=torch.int32)
    table = torch.zeros((len(lens), n_blk), dtype=torch.int32)
    nxt = 1
    for r, ln in enumerate(lens):
        for j in range(-(-ln // p)):
            table[r, j] = nxt
            hi = min(p, ln - j * p)
            posp[nxt, :hi] = torch.arange(j * p, j * p + hi)
            nxt += 1
    cur = torch.tensor([ln - 1 for ln in lens], dtype=torch.int32)
    return posp.to(device), table.to(device), cur.to(device)


def live_work(posp, table, cur, window=None):
    """(pages, valid slots) this table's data needs: a page counts when it
    holds a valid slot (a window can leave a row's early pages empty)."""
    pos = posp.cpu()[table.cpu().long()]                  # [B, n_blk, P]
    c = cur.cpu()[:, None, None]
    ok = (pos >= 0) & (pos <= c)
    if window is not None:
        ok &= pos > c - window
    ok &= table.cpu()[:, :, None] != 0
    return int(ok.any(-1).sum()), int(ok.sum())


def _live_blocks(ln: int, p: int = 16) -> int:
    """KVCache.live_blocks for one row: its pages, rounded up to a power
    of two."""
    return 1 << (max(1, -(-ln // p)) - 1).bit_length()


def bitwise_rows(name, call, lens, args_of_row, batch_out):
    """Each row alone must give the bits it gives in the batch
    (``args_of_row(r, width)``: row r's arguments; the paged kernels take
    the row at its own live-page width, against the batch at a wider table
    view)."""
    for r, ln in enumerate(lens):
        alone = call(*args_of_row(r, _live_blocks(ln)))
        if not torch.equal(alone[0], batch_out[r]):
            raise AssertionError(f"{name}: row {r} alone differs from the "
                                 "same row in the batch")
    emit({"check": name, "bitwise_rows": len(lens), "ok": True})


#: B4's shapes (lens, kv heads, window, table view): the OLMoE check (MHA,
#: 16 heads), GQA g=4 under a window over pages, one row of 512 positions,
#: and rows whose live pages end one page past a chunk boundary (chunks
#: are 2 columns: 5, 3 and 17 pages)
FDP_SHAPES = {
    "olmoe_b8": ([512, 511, 480, 300, 129, 64, 16, 0], 16, None, 32),
    "gqa_window": ([512, 333, 200, 199, 57, 1, 0, 450], 4, 150, 32),
    "one_row_512": ([512], 16, None, 32),
    "past_chunk_boundary": ([80, 33, 272, 17], 16, None, 32),
}


def check_flash_decode_paged(cfg, flush, device):
    """B4 at OLMoE's widths (16 query heads of 128, pages of 16) on each of
    FDP_SHAPES, a 64-column table walked through a narrower view, each
    (row, head) held to ROW_TOL; then each row of the check and the GQA
    shape alone at its own live-page width against the batch at the full
    64 columns, bit for bit.  No single PyTorch call takes a block table:
    library_ms null."""
    from repro_torch.kernels import flash_decode_paged
    from repro_torch.kernels.flash_decode_paged import \
        flash_decode_paged_plain
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    hd, p, hq, n_blk = cfg.head_dim_, 16, cfg.num_heads, 64
    per = {}
    for tag, (lens, hkv, window, live) in FDP_SHAPES.items():
        b = len(lens)
        n = b * 32 + 1
        kp, vp = (torch.randn((n, p, hkv, hd), generator=gen, device=device,
                              dtype=torch.bfloat16) for _ in range(2))
        q = torch.randn((b, hq, hd), generator=gen, device=device,
                        dtype=torch.bfloat16)
        posp, table, cur = paged_positions(lens, n, p, n_blk, device)
        bt = table[:, :live]                    # truncated strided view
        args = (q, kp, vp, posp, bt, cur)
        got = flash_decode_paged(*args, window=window)
        err = compare_rows(f"flash_decode_paged_{tag}", got,
                           flash_decode_paged_plain(*args, window=window),
                           batch=b, heads=[hq, hkv], window=window,
                           live_positions=sum(lens), table_cols=live)
        if tag in ("olmoe_b8", "gqa_window"):
            bitwise_rows(
                f"flash_decode_paged_{tag}_rows",
                lambda *a: flash_decode_paged(*a, window=window), lens,
                lambda r, w: (q[r:r + 1], kp, vp, posp, table[r:r + 1, :w],
                              cur[r:r + 1]),
                flash_decode_paged(q, kp, vp, posp, table, cur,
                                   window=window))
        ms, plain_ms = time_calls(
            (lambda: flash_decode_paged(*args, window=window),
             lambda: flash_decode_paged_plain(*args, window=window)), flush)
        pages, slots = live_work(posp, bt, cur, window)
        nbytes = (pages * p * hkv * hd * 2 * 2 + pages * p * 4
                  + 2 * b * hq * hd * 2 + b * live * 4)
        per[tag] = (err, ms, plain_ms, nbytes, 4 * slots * hq * hd)
    return per


#: B7's shapes (lens, table view): the DeepSeek check, one row of 512
FDPM_SHAPES = {
    "deepseek_b8": ([512, 511, 480, 300, 129, 64, 16, 0], 32),
    "one_row_512": ([512], 32),
}


def check_flash_decode_paged_mla(cfg, flush, device):
    """B7 at DeepSeek-V2-Lite's widths (16 heads, r 512, dr 64) on each of
    FDPM_SHAPES, pages of 16, a 64-column table walked through a 32-column
    view; each (row, head) latent of 512 held to ROW_TOL; then each row of
    the check alone at its own live-page width against the batch at the
    full 64 columns, bit for bit.  The work is the TPU kernel's f32 dots on
    bf16 latents: the bound takes the f32 rate whatever the kernel runs
    on.  No single PyTorch call takes a block table: library_ms null."""
    from repro_torch.kernels import flash_decode_paged_mla
    from repro_torch.kernels.flash_decode_paged import \
        flash_decode_paged_mla_plain
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    h, p, n_blk = cfg.num_heads, 16, 64
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    scale = 1.0 / (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** 0.5
    per = {}
    for tag, (lens, live) in FDPM_SHAPES.items():
        b = len(lens)
        n = b * 32 + 1
        ckvp, kropep = (torch.randn((n, p, w), generator=gen, device=device,
                                    dtype=torch.bfloat16) for w in (r, dr))
        q_lat, q_rope = (torch.randn((b, h, w), generator=gen, device=device)
                         for w in (r, dr))
        posp, table, cur = paged_positions(lens, n, p, n_blk, device)
        args = (q_lat, q_rope, ckvp, kropep, posp, table[:, :live], cur)
        err = compare_rows(f"flash_decode_paged_mla_{tag}",
                           flash_decode_paged_mla(*args, scale=scale),
                           flash_decode_paged_mla_plain(*args, scale=scale),
                           batch=b, heads=h, latent=[r, dr],
                           live_positions=sum(lens), table_cols=live)
        if tag == "deepseek_b8":
            bitwise_rows(
                f"flash_decode_paged_mla_{tag}_rows",
                lambda *a: flash_decode_paged_mla(*a, scale=scale), lens,
                lambda i, w: (q_lat[i:i + 1], q_rope[i:i + 1], ckvp, kropep,
                              posp, table[i:i + 1, :w], cur[i:i + 1]),
                flash_decode_paged_mla(q_lat, q_rope, ckvp, kropep, posp,
                                       table, cur, scale=scale))
        ms, plain_ms = time_calls(
            (lambda: flash_decode_paged_mla(*args, scale=scale),
             lambda: flash_decode_paged_mla_plain(*args, scale=scale)), flush)
        pages, slots = live_work(posp, table[:, :live], cur)
        nbytes = (pages * p * (r + dr) * 2 + pages * p * 4
                  + b * h * (r + dr) * 4 + b * h * r * 4 + b * live * 4
                  + b * 4)
        flops = slots * h * (2 * (r + dr) + 2 * r)
        per[tag] = (err, ms, plain_ms, nbytes, flops, None, None, F32_FLOPS)
    return per


def _causal_pairs(s: int, window) -> int:
    """(query, key) pairs a causal (windowed) mask leaves visible."""
    if window is None:
        return s * (s + 1) // 2
    return sum(min(i + 1, window) for i in range(s))


def check_flash_attention(cfg, flush, device):
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    hq, hd = cfg.num_heads, cfg.head_dim_

    def qkv(b, hkv, s, hd, strided):
        if strided:                      # the model's [B, S, H, hd] views
            return [torch.randn((b, s, h, hd), generator=gen, device=device,
                                dtype=torch.bfloat16).transpose(1, 2)
                    for h in (hq, hkv, hkv)]
        return [torch.randn(shape, generator=gen, device=device,
                            dtype=torch.bfloat16)
                for shape in ((b, hq, s, hd), (b, hkv, s, hd),
                              (b, hkv, s, hd))]

    # the forward's shape, a ragged whole-prompt prefill, GQA g=4 with a
    # sliding window (OLMoE is MHA without one), and the edges of the
    # tiling: hd 64, a ragged S inside one tile and across several, and
    # strided views of [B, S, H, hd] activations
    shapes = {"forward": (4, cfg.num_kv_heads, 512, None, hd, False),
              "prefill_ragged": (1, cfg.num_kv_heads, 200, None, hd, False),
              "gqa_window": (2, hq // 4, 384, 100, hd, False),
              "hd64_forward": (4, cfg.num_kv_heads, 512, None, 64, False),
              "hd64_s37_gqa_window": (1, hq // 4, 37, 16, 64, False),
              "strided_s200_gqa_window": (2, hq // 4, 200, 100, hd, True)}
    errs = []
    for tag, (b, hkv, s, window, hd, strided) in shapes.items():
        args = qkv(b, hkv, s, hd, strided)
        got = flash_attention(*args, window=window)
        if got.stride() != args[0].stride():
            raise AssertionError(f"flash_attention_{tag}: output strides "
                                 f"{got.stride()} != q's {args[0].stride()}")
        errs.append(compare_rows(f"flash_attention_{tag}", got,
                                 flash_attention_plain(*args, window=window),
                                 shape=[b, hq, hkv, s, hd], window=window,
                                 strided=strided))
    b, hkv, s, _, hd, _ = shapes["forward"]
    q, k, v = qkv(b, hkv, s, hd, False)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms, plain_ms, lib_ms = time_calls(
        (lambda: flash_attention(q, k, v),
         lambda: flash_attention_plain(q, k, v),
         lambda: sdpa(q, k, v, is_causal=True)), flush)
    nbytes = (2 * b * hq * s * hd + 2 * b * hkv * s * hd) * 2
    flops = 4 * b * hq * hd * _causal_pairs(s, None)
    return max(errs), ms, plain_ms, nbytes, flops, lib_ms


def _decode_cache(gen, device, lens, s_buf, hkv, hd):
    """k, v [B, S_buf, Hkv, hd] and pos [B, S_buf] as the engine leaves
    them: row b holds positions 0..lens[b]-1 at slot pos % S_buf."""
    b = len(lens)
    k, v = (torch.randn((b, s_buf, hkv, hd), generator=gen, device=device,
                        dtype=torch.bfloat16) for _ in range(2))
    pos = torch.full((b, s_buf), -1, dtype=torch.int32)
    for r, ln in enumerate(lens):
        p = torch.arange(max(ln - s_buf, 0), ln, dtype=torch.int32)
        pos[r, p % s_buf] = p
    cur = torch.tensor([ln - 1 for ln in lens], dtype=torch.int32)
    return k, v, pos.to(device), cur.to(device)


#: B8's shapes (lens, cache slots, query heads a kv head, window): the
#: OLMoE check (MHA), GQA g=4 over a 200-slot ring that has wrapped under a
#: 150 window, one row of 512 positions, and rows at the edges of the
#: 32-slot chunks (1, 31, 32, 33, 64, 65 and 97 slots, an idle row)
FD_SHAPES = {
    "olmoe_b8": ([512, 511, 480, 300, 129, 64, 16, 0], 512, 1, None),
    "gqa_window": ([700, 333, 200, 199, 57, 1, 0, 450], 200, 4, 150),
    "one_row_512": ([512], 512, 1, None),
    "chunk_edges": ([1, 31, 32, 33, 64, 65, 97, 0], 512, 1, None),
}


def check_flash_decode(cfg, flush, device):
    """B8 at OLMoE's widths (16 query heads of 128) on each of FD_SHAPES,
    each (row, head) held to ROW_TOL; then each row of the check and of the
    GQA shape alone against the same row in the batch, bit for bit.  Timed
    against the plain version and, on the MHA shapes, the library's
    attention with a boolean mask built from pos (library_ms)."""
    from repro_torch.kernels import flash_decode
    from repro_torch.kernels.flash_decode import flash_decode_plain
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    hq, hd = cfg.num_heads, cfg.head_dim_
    sdpa = torch.nn.functional.scaled_dot_product_attention
    per = {}
    for tag, (lens, s_buf, group, window) in FD_SHAPES.items():
        b, hkv = len(lens), hq // group
        q = torch.randn((b, hq, hd), generator=gen, device=device,
                        dtype=torch.bfloat16)
        k, v, pos, cur = _decode_cache(gen, device, lens, s_buf, hkv, hd)
        args = (q, k, v, pos, cur)
        got = flash_decode(*args, window=window)
        err = compare_rows(f"flash_decode_{tag}", got,
                           flash_decode_plain(*args, window=window),
                           batch=b, heads=[hq, hkv], slots=s_buf,
                           window=window, live_positions=sum(lens))
        if tag in ("olmoe_b8", "gqa_window"):
            bitwise_rows(
                f"flash_decode_{tag}_rows",
                lambda *a: flash_decode(*a, window=window), lens,
                lambda r, _: tuple(t[r:r + 1] for t in args), got)
        valid = (pos >= 0) & (pos <= cur[:, None])
        if window is not None:
            valid &= pos > cur[:, None] - window
        fns = [lambda: flash_decode(*args, window=window),
               lambda: flash_decode_plain(*args, window=window)]
        if hkv == hq:
            qm, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
            mask = valid[:, None, None, :]
            fns.append(lambda: sdpa(qm, kt, vt, attn_mask=mask))
        ms, plain_ms, *lib = time_calls(fns, flush)
        live = int(valid.sum())           # the slots the function must read
        nbytes = (live * hkv * hd * 2 * 2 + live * 4 + 2 * b * hq * hd * 2
                  + b * 4)
        per[tag] = (err, ms, plain_ms, nbytes, 4 * live * hq * hd,
                    lib[0] if lib else None)
    return per


def kernel_row(name, source, replaces, err, ms, plain_ms, nbytes, flops,
               library_ms=None, extra=None, flop_rate=BF16_FLOPS):
    """A kernel's numbers; ``extra`` adds keys of its own (moe_decode: the
    distinct routed experts and the bytes they make)."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / flop_rate * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, **(extra or {})}


#: the numbers a row keeps for each of its dtypes or shapes
NESTED_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "sibling_ms", "experts", "bytes")


def nested_row(name, source, replaces, per, nest):
    """A kernel's row over several dtypes or shapes (``nest``: "dtypes"
    or "shapes"): the first one's numbers at the top level (the row's
    keys), each one's under ``nest``; ``max_abs_err`` is the largest."""
    rows = {key: kernel_row(name, source, replaces, *v)
            for key, v in per.items()}
    row = dict(next(iter(rows.values())))
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    row[nest] = {key: {k: r[k] for k in NESTED_KEYS if k in r}
                 for key, r in rows.items()}
    return row


# --------------------------------------------------------------------------- #
# phase 3: serving
# --------------------------------------------------------------------------- #


def requests(cfg, seed: int, n: int = 8, lo: int = 32, hi: int = 257,
             max_new: int = 32, plans=None):
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               rng.integers(lo, hi)).astype(np.int32),
                    max_new_tokens=max_new,
                    plan=plans[i] if plans else None) for i in range(n)]


def serve_record(eng) -> dict:
    """The last serve's numbers: its stats, the wall time a decode step
    took and the host's part of it (up to the step's return, before
    sampling waits for the card), and the runner's CUDA graphs (held, and
    captured and replayed in this serve, with the host seconds the
    captures took: each key's eager first step and its capture)."""
    s = eng.stats
    steps = max(s["steps"], 1)
    rec = {k: s[k] for k in ("prefill_tokens", "decode_tokens", "steps",
                             "preemptions", "mixed_plan_steps", "wall_s",
                             "graphs_captured", "capture_s",
                             "graph_replays")}
    rec.update(tok_s=eng.throughput(),
               decode_step_ms=s["decode_s"] / steps * 1e3,
               decode_host_ms=s["decode_host_s"] / steps * 1e3,
               graphs=eng.runner.stats["graphs"], eager=not eng.runner.graphs)
    return rec


def same_tokens(tag, got, want) -> None:
    """Greedy tokens of two serves of the same requests must be equal."""
    for a, b in zip(got, want):
        if a.uid != b.uid or a.tokens != b.tokens:
            raise AssertionError(f"{tag}: request {b.uid} served "
                                 f"{a.tokens} against {b.tokens}")
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} results against "
                             f"{len(want)}")


def eager_twin(tag, make_engine, reqs, want, counts, plan=None):
    """Serve ``reqs`` on an engine whose steps run eagerly (the oracle
    the graphs are held to): its greedy tokens must equal the graphed
    serve's ``want`` and its launch counts the graphed serve's
    ``counts``.  Returns (its record, its counts)."""
    eng = make_engine(graphs=False)
    res, c = counted(lambda: eng.serve(reqs, plan=plan))
    same_tokens(f"{tag} graphed vs eager", want, res)
    if c != counts:
        raise AssertionError(f"{tag}: eager launches {c} against the "
                             f"graphed serve's {counts}")
    rec = serve_record(eng)
    del eng
    return rec, c


def counted(step):
    """Run ``step`` with every launch counter zeroed just before it; return
    (its result, the counts read just after)."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    out = step()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def check_results(tag, results, cfg, max_new):
    for r in results:
        if r.finished_reason != "length" or len(r.tokens) != max_new:
            raise AssertionError(f"{tag}: request {r.uid} ended "
                                 f"{r.finished_reason!r} after "
                                 f"{len(r.tokens)} tokens")
        if not all(0 <= t < cfg.padded_vocab for t in r.tokens):
            raise AssertionError(f"{tag}: request {r.uid} token out of range")


def ref_inputs(cfg, device, b: int = 2, c: int = 64):
    """The reference checks' fixed inputs: ``b`` rows of ``c`` prompt
    tokens, one next token each, and a block table of 8 pages a row."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (b, c), generator=gen)
    nxt = torch.randint(0, cfg.vocab_size, (b,), generator=gen).int()
    positions = torch.arange(c).repeat(b, 1).int()
    bt = torch.arange(1, 1 + b * 8, dtype=torch.int32).reshape(b, 8)
    dev = {n: t.to(device) for n, t in (("tokens", tokens), ("nxt", nxt),
                                        ("positions", positions), ("bt", bt))}
    dev["pos_c"] = torch.full((b,), c, dtype=torch.int32, device=device)
    return dev


def paged_logits(params, cfg, opts, dev, page_size: int = 16):
    """Logits of one chunk prefill of ``dev``'s prompts on a fresh paged
    pool, then of one decode step (the table walked 8 columns wide)."""
    from repro_torch import models
    b = dev["tokens"].shape[0]
    caches = models.init_caches(cfg, page_size=page_size,
                                num_pages=b * 8 + 1,
                                device=dev["tokens"].device)
    lg1, caches = models.chunk_prefill_fn(
        params, cfg, dev["tokens"], dev["positions"], caches,
        block_tables=dev["bt"], opts=opts)
    lg2, _ = models.decode_fn(params, cfg, dev["nxt"], dev["pos_c"], caches,
                              block_tables=dev["bt"], opts=opts,
                              kernel_blocks=8)
    return lg1.float(), lg2.float()


def gate_logits(check, got_all, want_all, **extra):
    """Print the (prefill, decode) logits' agreement and fail unless every
    row is finite and within LOGITS_TOL."""
    rec = {"check": check, "tol": LOGITS_TOL}
    for i, step in enumerate(("prefill", "decode")):
        got, want = got_all[i], want_all[i]
        rec[f"{step}_max_row_rel_err"] = row_rel_err(got, want).max().item()
        rec[f"{step}_max_abs_diff"] = (got - want).abs().max().item()
        rec[f"{step}_argmax_equal"] = (
            got.argmax(-1) == want.argmax(-1)).float().mean().item()
        rec[f"{step}_finite"] = bool(torch.isfinite(got).all())
    rec.update(extra)
    emit(rec)
    if not all(rec[f"{s}_finite"] and rec[f"{s}_max_row_rel_err"] <= LOGITS_TOL
               for s in ("prefill", "decode")):
        raise AssertionError(f"reference check failed: {rec}")


def reference_check(params, cfg, device):
    """Kernel paths vs plain paths on small inputs and the same weights,
    through the model cut to its first layer: two rows of 64 prompt tokens
    prefilled (a chunk on the paged pool; a whole prompt on the contiguous
    cache, the forward ``loss_fn`` runs), then one decode step on the same
    fixed tokens; the logits of each prompt's last token and of each
    decoded token must agree within LOGITS_TOL (relative L2 error per
    row).  Then the whole forward's logits, every token's, with only
    ``moe_gmm`` on the kernel side: the attention is the same plain code on
    both sides, so the router sees identical inputs.  With the attention
    kernels on too, their bf16 rounding reaches the router, and a token
    whose 8th and 9th expert scores nearly tie gets another top-8 set: in a
    chip run 6 of the 128 tokens did, and exactly those rows were off (by
    0.18-0.31; every other row within 0.0096).  At full depth 16 layers
    amplify such flips into unrelated logits (cosine 0.84).

    The paged check runs again with the layer's experts quantized to int8
    and to int4 (``moe_gmm_quant`` in the chunk, ``moe_decode_quant`` in
    the decode step, against their plain versions), gated the same way;
    the layer's experts are first scaled apart per channel
    (``varied_experts``); each quantized model's error against the bf16
    model's logits (on the same scaled weights) is printed, not gated: on
    random weights it is a sanity reading, not a quality claim."""
    from repro_torch import models
    from repro_torch.models.moe import QUANT_DTYPES, quantize_expert_params
    cfg = cfg.with_(num_layers=1)
    params = dict(params, layers=params["layers"][:1])
    dev = ref_inputs(cfg, device)
    b, c = dev["tokens"].shape
    pos_c = dev["pos_c"]

    def paged(opts, prm=params):
        return paged_logits(prm, cfg, opts, dev)

    def contiguous(opts):
        caches = models.init_caches(cfg, b, 2 * c, layout="contiguous",
                                    device=device)
        lg1, caches = models.prefill_fn(params, cfg, {"tokens": dev["tokens"]},
                                        caches, opts=opts)
        lg2, _ = models.decode_fn(params, cfg, dev["nxt"], pos_c, caches,
                                  opts=opts)
        return lg1.float(), lg2.float()

    plain = models.ModelOpts(use_moe_decode_kernel=True)
    paths = {
        "reference_logits": (paged, models.ModelOpts(
            use_moe_kernel=True, use_paged_kernel=True,
            use_moe_decode_kernel=True)),
        "reference_logits_contiguous": (contiguous, models.ModelOpts(
            use_flash=True, use_flash_decode=True, use_moe_kernel=True,
            use_moe_decode_kernel=True)),
    }
    # the quantized checks run on the layer's experts scaled apart per
    # channel (varied_experts), so that their scales differ
    layer0 = params["layers"][0]
    vp = dict(params, layers=[dict(layer0,
                                   moe=varied_experts(layer0["moe"]))])
    bf16_plain = paged(plain, vp)
    for dt in QUANT_DTYPES:
        qp = quantize_expert_params(vp, cfg, dt)
        paths[f"reference_logits_{dt}"] = (
            lambda opts, qp=qp: paged(opts, qp),
            replace(paths["reference_logits"][1], expert_dtype=dt))
    for check, (run, kern) in paths.items():
        want_all = run(replace(plain, expert_dtype=kern.expert_dtype))
        extra = {}
        if kern.expert_dtype != "bf16":         # printed, not gated
            extra = {f"{step}_vs_bf16_max_row_rel_err": row_rel_err(
                want_all[i], bf16_plain[i]).max().item()
                for i, step in enumerate(("prefill", "decode"))}
        gate_logits(check, run(kern), want_all, **extra)

    # the config's own dense impl: moe_ffn in the chunk and in the decode
    # step (dense is never rerouted to moe_decode) against its bf16 plain
    # path, the reference's jnp form
    dense = cfg.with_(moe_impl="dense")
    got, counts = counted(lambda: paged_logits(
        params, dense, paths["reference_logits"][1], dev))
    gate_logits("reference_logits_dense", got,
                paged_logits(params, dense, models.ModelOpts(), dev),
                launches={n: counts[n] for n in ("moe_ffn", "moe_gmm",
                                                 "moe_decode")})
    if counts["moe_ffn"] != 2 or counts["moe_gmm"] or counts["moe_decode"]:
        raise AssertionError(f"dense reference check launched {counts}")

    from repro_torch.models.transformer import forward, lm_logits
    lg = [lm_logits(params, cfg, forward(params, cfg, dev["tokens"],
                                         dev["positions"], opts=o)[0])
          for o in (models.ModelOpts(use_moe_kernel=True),
                    models.ModelOpts())]
    rec = {"check": "reference_forward_logits", "tol": LOGITS_TOL,
           "rows": b * c,
           "max_row_rel_err": row_rel_err(*lg).max().item(),
           "argmax_equal": (lg[0].argmax(-1) == lg[1].argmax(-1)).float().mean().item(),
           "finite": bool(torch.isfinite(lg[0]).all())}
    emit(rec)
    if not (rec["finite"] and rec["max_row_rel_err"] <= LOGITS_TOL):
        raise AssertionError(f"reference forward check failed: {rec}")


# --------------------------------------------------------------------------- #
# phases 3b-3d: the prefix cache, the plan ladder, open-loop arrivals
# --------------------------------------------------------------------------- #

#: the prefix workload: one shared head of 12 full pages (3 whole chunks of
#: 64), a random suffix of 1-15 tokens, and two requests whose prompt is
#: exactly the head
PREFIX_HEAD = 192
HEAD_ONLY = (7, 15)
#: the pool of the pressure serve, in pages (8 slots of up to 15 pages
#: each would need 120)
PRESSURE_PAGES = 48
#: host accounting of the prefix serves, from a CPU rehearsal of
#: serve_prefix on the reduced config (the counts depend only on the
#: prompt lengths and the engine's settings, never on the weights, so the
#: card must give the same ones)
PREFIX_COUNTS = {
    "warm": {"prefix_hit_tokens": 3070, "cow_copies": 2,
             "prefill_tokens": 114},
    "pressure": {"prefix_hit_tokens": 3342, "cow_copies": 2,
                 "prefill_tokens": 818, "recompute_tokens": 74,
                 "preemptions": 5, "cache_evictions": 16},
}


def prefix_requests(cfg, seed: int, n: int = 16, max_new: int = 32,
                    head_only=HEAD_ONLY):
    """``n`` requests on one ``PREFIX_HEAD``-token head, each with a random
    suffix of 1-15 tokens except ``head_only``, whose prompt is the head.
    The lengths are drawn first, so they do not depend on the vocabulary."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 16, n)
    head = rng.integers(0, cfg.vocab_size, PREFIX_HEAD)
    reqs = []
    for i in range(n):
        suffix = rng.integers(0, cfg.vocab_size, lens[i])
        prompt = head if i in head_only else np.concatenate([head, suffix])
        reqs.append(Request(uid=i, prompt=prompt.astype(np.int32),
                            max_new_tokens=max_new))
    return reqs


@contextmanager
def first_token_rows(eng):
    """Record {uid: the logits row its first token was sampled from} while
    ``eng`` serves (wraps the instance's ``_sample`` and ``_first_token``;
    the engine itself has no hook)."""
    rows, last = {}, {}
    sample, first = eng._sample, eng._first_token

    def sampling(logits):
        last["logits"] = logits
        return sample(logits)

    def first_token(t, tok):
        rows[t.req.uid] = last["logits"][t.slot].float().clone()
        first(t, tok)
    eng._sample, eng._first_token = sampling, first_token
    try:
        yield rows
    finally:
        del eng._sample, eng._first_token


def drained(tag, eng) -> None:
    """After a drain every page is free again: none in use, no refcount
    held, the free list plus the LRU the whole pool but the trash page."""
    kv = eng.kv
    if (kv.stats["pages_in_use"] or int(kv.ref.sum())
            or kv.free_pages() != kv.num_pages - 1):
        raise AssertionError(f"{tag}: after the drain {kv.stats}, ref sum "
                             f"{int(kv.ref.sum())}, {kv.free_pages()} of "
                             f"{kv.num_pages - 1} pages free")


def only(results, uids):
    return [r for r in results if r.uid in uids]


def agreement(got, want) -> dict:
    """Tokens equal position by position, over all requests."""
    same = sum(a == b for g, w in zip(got, want)
               for a, b in zip(g.tokens, w.tokens))
    return {"equal_tokens": same,
            "tokens": sum(len(w.tokens) for w in want),
            "equal_requests": sum(g.tokens == w.tokens
                                  for g, w in zip(got, want))}


def host_counts(stats, keys) -> dict:
    return {k: int(stats[k]) for k in keys}


def check_counts(tag, stats, want) -> dict:
    """The serve's host accounting must equal the CPU rehearsal's."""
    got = host_counts(stats, want)
    if got != want:
        raise AssertionError(f"{tag}: host counts {got} against the "
                             f"rehearsal's {want}")
    return got


def check_cow_pages(cfg, device) -> dict:
    """Copy-on-write's device half: every leaf of every layer filled with
    random bytes (``posp`` with the positions a page holds), three pages
    registered, then adopted by another slot with ``keep_below`` in the
    middle of the third.  The private copy must hold the source's bytes
    bit for bit in every leaf, its ``posp`` -1 at and past ``keep_below``,
    and the source page must be untouched."""
    from repro_torch.serving import KVCache
    kv = KVCache(cfg, 2, 512, page_size=16, num_pages=8, prefix_cache=True,
                 device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    for layer in kv.caches:
        for name, leaf in layer.items():
            if name == "posp":      # page p as block p - 1 of a sequence
                leaf.copy_(torch.arange(leaf.numel(), dtype=torch.int32,
                                        device=device).view_as(leaf) - 16)
            else:
                b = leaf.view(torch.uint8)
                b.copy_(torch.randint(0, 256, b.shape, generator=gen,
                                      device=device, dtype=torch.uint8))
    salt, keep = ("base", "bf16"), 40
    toks = np.arange(48, dtype=np.int32)
    assert kv.allocate(0, 48)
    chain = kv.prefix_root(salt)
    for j, page in enumerate(kv.slot_pages(0)):
        chain = kv.register_page(chain, toks[16 * j:16 * j + 16], page)
    src = kv.slot_pages(0)[2]
    before = [{n: t[src].clone() for n, t in layer.items()}
              for layer in kv.caches]
    pages, hit, _ = kv.match_prefix(salt, toks, keep)
    if hit != keep or not kv.allocate(1, 48, shared=pages, keep_below=hit):
        raise AssertionError(f"cow check: hit {hit}, pages {pages}")
    dst = kv.slot_pages(1)[2]
    if dst == src or kv.slot_pages(1)[:2] != kv.slot_pages(0)[:2]:
        raise AssertionError(f"cow check: slot pages {kv.slot_pages(0)} "
                             f"and {kv.slot_pages(1)}")
    nbytes = 0
    as_bytes = lambda t: t.contiguous().view(torch.uint8)   # NaN bits too
    for layer, old in zip(kv.caches, before):
        for name, leaf in layer.items():
            if not torch.equal(as_bytes(leaf[src]), as_bytes(old[name])):
                raise AssertionError(f"cow check: source page {name} moved")
            if name == "posp":
                want = torch.where(old[name] < keep, old[name], -1)
                ok = (torch.equal(leaf[dst], want)
                      and bool((leaf[dst][keep - 32:] == -1).all())
                      and leaf[dst][:keep - 32].tolist()
                      == list(range(32, keep)))
            else:
                ok = torch.equal(as_bytes(leaf[dst]), as_bytes(old[name]))
            if not ok:
                raise AssertionError(f"cow check: {name} of the copy")
            nbytes += leaf[dst].numel() * leaf.element_size()
    table = kv.block_tables().cpu().numpy()
    if not np.array_equal(table, kv.table):
        raise AssertionError("cow check: the device table is stale")
    rec = {"check": "cow_device_copy", "src": src, "dst": dst,
           "keep_below": keep, "bytes_compared": nbytes,
           "bitwise_equal": True, "posp_masked": True}
    emit(rec)
    return rec


def serve_prefix(params, cfg, eng_off, device, t_start):
    """Phase 3b: the prefix workload served (a) on ``eng_off`` (the cache
    off), (b) cold and (c) warm on one engine with the cache on, (d) by an
    eager twin of (c) warmed the same way, then on a pool of
    PRESSURE_PAGES with its eager twin, then the copy-on-write device
    check.  Returns {step: (counts, kernels the step must launch)}."""
    from repro_torch import models
    from repro_torch.serving import Engine
    paged_kernels = ("moe_gmm", "moe_decode", "flash_decode_paged")
    aligned = [i for i in range(16) if i not in HEAD_ONLY]
    rec, need = {"phase": "serve_prefix"}, {}

    def make(graphs=True, **kw):
        return Engine(cfg, params, max_batch=8, max_len=512,
                      prefill_chunk=64, use_kernel=True, use_moe_decode=True,
                      prefix_cache=True,
                      opts=models.ModelOpts(use_moe_kernel=True),
                      device=device, graphs=graphs, **kw)

    def warm_up(eng):       # captures the keys; a head of another seed
        eng.serve(prefix_requests(cfg, seed=2, n=2, max_new=4))

    def serve(tag, eng):
        res, counts = counted(lambda: eng.serve(prefix_requests(cfg, 1)))
        check_results(f"prefix {tag}", res, cfg, 32)
        rec[f"{tag}_stats"] = dict(serve_record(eng), **host_counts(
            eng.stats, ("prefix_hit_tokens", "cow_copies",
                        "cache_evictions")),
            prefix_hit_rate=eng.stats["prefix_hit_rate"])
        need[f"prefix_{tag}"] = (counts, paged_kernels)
        if eng.prefix_cache:
            drained(f"prefix {tag}", eng)
        return res, counts

    with first_token_rows(eng_off) as rows_off:
        res_off, _ = serve("off", eng_off)
    eng = make()
    warm_up(eng)
    drained("prefix warm-up", eng)
    res_cold, _ = serve("cold", eng)
    with first_token_rows(eng) as rows_warm:
        res_warm, warm_counts = serve("warm", eng)
    for tag, res in (("cold", res_cold), ("warm", res_warm)):
        same_tokens(f"prefix {tag} vs off (aligned hits)",
                    only(res, aligned), only(res_off, aligned))
    warm = rec["warm_stats"]
    if warm["graphs_captured"] or warm["cow_copies"] != 2:
        raise AssertionError(f"prefix warm: {warm}")
    rec["warm_counts"] = check_counts("prefix warm", eng.stats,
                                      PREFIX_COUNTS["warm"])
    rec["warm_hits"] = {r.uid: r.prefix_hit_tokens for r in res_warm}
    for uid in HEAD_ONLY:
        if res_warm[uid].prefix_hit_tokens != PREFIX_HEAD - 1:
            raise AssertionError(f"prefix warm: request {uid} hit "
                                 f"{res_warm[uid].prefix_hit_tokens}")
    compare_rows("prefix_head_only_first_token_rows",
                 torch.stack([rows_warm[u] for u in HEAD_ONLY]),
                 torch.stack([rows_off[u] for u in HEAD_ONLY]),
                 uids=list(HEAD_ONLY))
    rec["head_only_agreement"] = agreement(only(res_warm, HEAD_ONLY),
                                           only(res_off, HEAD_ONLY))
    del eng

    eng = make(graphs=False)
    warm_up(eng)
    eng.serve(prefix_requests(cfg, 1))
    res, counts = counted(lambda: eng.serve(prefix_requests(cfg, 1)))
    drained("prefix warm eager", eng)
    same_tokens("prefix warm graphed vs eager", res_warm, res)
    if counts != warm_counts:
        raise AssertionError(f"prefix warm: eager launches {counts} "
                             f"against {warm_counts}")
    need["prefix_warm_eager"] = (counts, paged_kernels)
    rec["warm_eager_stats"] = serve_record(eng)
    del eng

    for graphs in (True, False):
        eng = make(graphs=graphs, num_pages=PRESSURE_PAGES)
        warm_up(eng)
        tag = "pressure" if graphs else "pressure_eager"
        res, counts = serve(tag, eng)
        s = eng.stats
        if s["preemptions"] <= 0 or s["cache_evictions"] <= 0:
            raise AssertionError(f"prefix {tag}: {s['preemptions']} "
                                 f"preemptions, {s['cache_evictions']} "
                                 "evictions")
        rec[f"{tag}_counts"] = check_counts(f"prefix {tag}", s,
                                            PREFIX_COUNTS["pressure"])
        if graphs:
            res_p, counts_p = res, counts
        else:
            same_tokens("prefix pressure graphed vs eager", res_p, res)
            if counts != counts_p:
                raise AssertionError(f"prefix pressure: eager launches "
                                     f"{counts} against {counts_p}")
        del eng
    rec["pressure_vs_off"] = agreement(res_p, res_off)
    rec["cow_check"] = check_cow_pages(cfg, device)
    rec["tokens_equal"] = {"aligned_off_cold_warm": True,
                           "warm_graphed_vs_eager": True,
                           "pressure_graphed_vs_eager": True}
    emit(dict(rec, seconds_total=time.perf_counter() - t_start))
    return need


def serve_ladder(params, cfg, eng, plan, device, t_start):
    """Phase 3c: 16 requests asking for base, under the ladder base -> lexi
    with ``degrade_under_pressure``; their single-plan serves (base, lexi)
    on ``eng`` first.  Returns (the base serve's results, need)."""
    from repro_torch import models
    from repro_torch.serving import Engine
    paged_kernels = ("moe_gmm", "moe_decode", "flash_decode_paged")
    reqs = lambda: requests(cfg, seed=0, n=16)
    res_base = eng.serve(reqs())
    base_rec = serve_record(eng)
    res_lexi = eng.serve(reqs(), plan="lexi")
    lexi_rec = serve_record(eng)

    def make(graphs=True):
        e = Engine(cfg, params, max_batch=8, max_len=512, prefill_chunk=64,
                   use_kernel=True, use_moe_decode=True,
                   degrade_under_pressure=True,
                   opts=models.ModelOpts(use_moe_kernel=True), device=device,
                   graphs=graphs)
        e.add_plan("lexi", plan)
        e.set_plan_ladder(["base", "lexi"])
        return e
    lad = make()
    lad.serve(reqs())                               # captures the buckets
    res, counts = counted(lambda: lad.serve(reqs()))
    check_results("ladder", res, cfg, 32)
    rec = {"phase": "serve_ladder", "stats": serve_record(lad),
           "base_stats": base_rec, "lexi_stats": lexi_rec,
           "plan_degradations": lad.stats["plan_degradations"],
           "degraded": [r.uid for r in res if r.plan_degradations]}
    if rec["plan_degradations"] <= 0 or rec["stats"]["mixed_plan_steps"] <= 0:
        raise AssertionError(f"ladder: {rec}")
    for r in res:
        want = res_lexi if r.plan_degradations else res_base
        if (r.plan_degradations > 1 or r.served_plan
                != ("lexi" if r.plan_degradations else "base")):
            raise AssertionError(f"ladder: request {r.uid} {r}")
        same_tokens(f"ladder request {r.uid} ({r.served_plan})", [r],
                    [want[r.uid]])
    need = {"ladder": (counts, paged_kernels)}
    del lad
    rec["eager_stats"], c = eager_twin("ladder", make, reqs(), res, counts)
    need["ladder_eager"] = (c, paged_kernels)
    rec.update(launches=counts, tokens_equal_single_plan_serves=True,
               tokens_equal_graphed_vs_eager=True)
    emit(dict(rec, seconds_total=time.perf_counter() - t_start))
    return res_base, need


def serve_open_loop(params, cfg, res_closed, device, t_start):
    """Phase 3d: the 16 requests arriving at steps 0, 2, 4, ... on a
    VirtualClock (one tick a step): tokens equal to the closed-loop serve's
    ``res_closed`` and to the eager twin's."""
    from repro_torch import models
    from repro_torch.serving import Engine, VirtualClock
    paged_kernels = ("moe_gmm", "moe_decode", "flash_decode_paged")
    arrivals = [2.0 * i for i in range(16)]

    def make(graphs=True):
        return Engine(cfg, params, max_batch=8, max_len=512,
                      prefill_chunk=64, use_kernel=True, use_moe_decode=True,
                      opts=models.ModelOpts(use_moe_kernel=True),
                      clock=VirtualClock(tick=1.0), device=device,
                      graphs=graphs)
    out = {}
    for graphs in (True, False):
        eng = make(graphs)
        if graphs:                      # the warm-up captures every key
            eng.serve(requests(cfg, seed=0, n=16), arrival_times=arrivals)
        res, counts = counted(lambda: eng.serve(
            requests(cfg, seed=0, n=16), arrival_times=arrivals))
        check_results("open loop", res, cfg, 32)
        out[graphs] = (res, counts, dict(eng.stats))
        del eng
    res, counts, stats = out[True]
    same_tokens("open loop vs closed loop", res, res_closed)
    same_tokens("open loop graphed vs eager", res, out[False][0])
    if out[False][1] != counts:
        raise AssertionError(f"open loop: eager launches {out[False][1]} "
                             f"against {counts}")
    rec = {"phase": "serve_open_loop", "arrival_steps": arrivals,
           "ttft_p50_steps": stats["ttft_p50_s"],
           "ttft_p95_steps": stats["ttft_p95_s"],
           "engine_steps_wall": stats["wall_s"], "launches": counts,
           "graphs_captured": stats["graphs_captured"],
           "graph_replays": stats["graph_replays"],
           "tokens_equal_closed_loop": True,
           "tokens_equal_graphed_vs_eager": True}
    emit(dict(rec, seconds_total=time.perf_counter() - t_start))
    return {"open_loop": (counts, paged_kernels),
            "open_loop_eager": (out[False][1], paged_kernels)}


def serve_contiguous_chunked(params, cfg, rows_paged, res_paged, device,
                             t_start):
    """Phase 5b: the 8 requests on the contiguous layout with chunked
    prefill (chunk 64) and ``flash_decode``: the chunk steps replay a CUDA
    graph, ``flash_attention`` never launches, tokens equal the eager
    twin's, and the first-token logits rows lie within ROW_TOL of the paged
    chunked serve's (``rows_paged``)."""
    from repro_torch import models
    from repro_torch.serving import Engine
    kernels_ = ("moe_gmm", "moe_decode", "flash_decode")

    def make(graphs=True):
        return Engine(cfg, params, max_batch=8, max_len=512,
                      cache_layout="contiguous", prefill_chunk=64,
                      use_moe_decode=True, opts=models.ModelOpts(
                          use_flash=True, use_flash_decode=True,
                          use_moe_kernel=True), device=device, graphs=graphs)
    eng = make()
    eng.serve(requests(cfg, seed=0))        # the warm-up captures each key
    with first_token_rows(eng) as rows:
        res, counts = counted(lambda: eng.serve(requests(cfg, seed=0)))
    check_results("contiguous chunked", res, cfg, 32)
    stats = serve_record(eng)
    chunk_key = ("base", "chunk", 64, "bf16")
    if (counts["flash_attention"] or stats["graphs_captured"]
            or not stats["graph_replays"]
            or eng.runner._steps.get(chunk_key) is None):
        raise AssertionError(f"contiguous chunked: launches {counts}, "
                             f"stats {stats}")
    uids = sorted(rows)
    compare_rows("contiguous_chunked_first_token_rows",
                 torch.stack([rows[u] for u in uids]),
                 torch.stack([rows_paged[u] for u in uids]))
    rec = {"phase": "serve_contiguous_chunked", "stats": stats,
           "launches": counts, "vs_paged": agreement(res, res_paged)}
    del eng
    rec["eager_stats"], c = eager_twin("contiguous chunked", make,
                                       requests(cfg, seed=0), res, counts)
    rec["tokens_equal_graphed_vs_eager"] = True
    emit(dict(rec, seconds_total=time.perf_counter() - t_start))
    return {"contiguous_chunked": (counts, kernels_),
            "contiguous_chunked_eager": (c, kernels_)}


# --------------------------------------------------------------------------- #
# phases 3e-3g: the HTTP front end, router lookahead
# --------------------------------------------------------------------------- #

#: the completions of api_server_checks (request i of serve's draw):
#: (plan, priority, stream); the first four also run one at a time
API_SPECS = [("base", 0, True), ("lexi", 0, False), ("base", 1, False),
             ("lexi", 1, True), ("base", 0, False), ("lexi", 0, True),
             ("base", 1, True), ("lexi", 1, False)]


def api_post(api, body, timeout=600):
    """One completion over a localhost socket -> (status, events): the
    NDJSON lines of a streamed answer, or [the JSON object]."""
    import http.client
    conn = http.client.HTTPConnection(api.host, api.port, timeout=timeout)
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(body))
        resp = conn.getresponse()
        raw = resp.read().decode()
        if resp.status == 200 and body.get("stream"):
            return 200, [json.loads(ln) for ln in raw.splitlines()]
        return resp.status, [json.loads(raw)]
    finally:
        conn.close()


def api_result(tag, status, events, stream, plan):
    """The final result of one completion, after the stream's checks:
    deltas concatenate to the text, the text is the detok of the tokens,
    the plan served is the one asked for."""
    from repro_torch.serving import default_decode
    if status != 200:
        raise AssertionError(f"{tag}: HTTP {status} {events}")
    res = events[-1]["result"] if stream else events[-1]
    if stream:
        if not events[-1].get("done") or not all(
                "delta" in ev for ev in events[:-1]):
            raise AssertionError(f"{tag}: stream events {events[-1]}")
        if "".join(ev["delta"] for ev in events[:-1]) != res["text"]:
            raise AssertionError(f"{tag}: deltas do not make the text")
    if res["text"] != default_decode(res["tokens"]):
        raise AssertionError(f"{tag}: text is not the detok of the tokens")
    if res["served_plan"] != plan or res["finished_reason"] != "length":
        raise AssertionError(f"{tag}: served {res['served_plan']!r}, ended "
                             f"{res['finished_reason']!r}")
    return res


def first_difference(got, want):
    """The first position where two token lists differ (None: equal)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return i
    return None if len(got) == len(want) else min(len(got), len(want))


def finite_tree(x) -> bool:
    if isinstance(x, dict):
        return all(finite_tree(v) for v in x.values())
    return not isinstance(x, float) or np.isfinite(x)


def api_server_checks(eng, cfg, device, t_start):
    """Phase 3e: an ``ApiServer`` over the paged ``gmm`` engine (the plan
    registered as "lexi").  Solo oracles first: each of API_SPECS served
    alone by ``eng.serve([req], detok=True)``.  (a) four completions one at
    a time equal their oracles in tokens and text; (b) eight client threads
    at once: every result's checks (``api_result``), and how many equal
    their oracles, with the first differing position of any that does not;
    (c) a client that walks away mid-stream: the pool's free pages and the
    uid come back, and the next completion equals its oracle; (d)
    ``/v1/stats`` finite while the wave runs; after ``close()``
    ``requests_total`` counts every completion and none is open; (e) the
    engine drained.  Returns need."""
    import socket
    import threading
    from repro_torch.serving import ApiServer
    paged_kernels = ("moe_gmm", "moe_decode", "flash_decode_paged")
    reqs = requests(cfg, seed=0)
    oracles = []
    for i, (plan, prio, _) in enumerate(API_SPECS):
        r = replace(reqs[i], plan=plan, priority=prio)
        (res,) = eng.serve([r], detok=True)
        oracles.append(res)
    body = lambda i: {"prompt": reqs[i].prompt.tolist(),      # noqa: E731
                      "max_new_tokens": reqs[i].max_new_tokens,
                      "plan": API_SPECS[i][0], "priority": API_SPECS[i][1],
                      "stream": API_SPECS[i][2]}
    free0 = eng.kv.free_pages()
    s0 = dict(eng.stats)
    g0 = eng.runner.stats["graphs"]
    rec = {"check": "api_server"}

    def exact(tag, i, res):
        o = oracles[i]
        if res["tokens"] != o.tokens or res["text"] != o.text:
            raise AssertionError(
                f"{tag}: completion {i} differs from its solo serve at "
                f"token {first_difference(res['tokens'], o.tokens)}")

    def run(step):
        with ApiServer(eng) as api:
            out = step(api)
        if api.error is not None:
            raise AssertionError(f"pump error {api.error!r}")
        return api, out

    def sequential(api):
        walls = []
        for i in range(4):
            t0 = time.perf_counter()
            status, ev = api_post(api, body(i))
            walls.append(time.perf_counter() - t0)
            exact("sequential", i, api_result(
                f"sequential {i}", status, ev, API_SPECS[i][2],
                API_SPECS[i][0]))
        return walls

    api, walls = counted(lambda: run(sequential))[0]
    rec["sequential_wall_s"] = walls
    rec["sequential_equal_solo"] = 4

    def wave(api):
        got = [None] * len(API_SPECS)
        scrapes, bad = [0], []
        stop = threading.Event()

        def client(i):
            got[i] = api_post(api, body(i))

        def scraper():
            import http.client
            conn = http.client.HTTPConnection(api.host, api.port,
                                              timeout=60)
            while not stop.is_set():
                conn.request("GET", "/v1/stats")
                stats = json.loads(conn.getresponse().read())
                scrapes[0] += 1
                if not finite_tree(stats):
                    bad.append(stats)
                time.sleep(0.005)
            conn.close()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(API_SPECS))]
        sc = threading.Thread(target=scraper)
        t0 = time.perf_counter()
        sc.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        stop.set()
        sc.join(timeout=60)
        if any(t.is_alive() for t in threads) or sc.is_alive():
            raise AssertionError("api wave: a client thread hung")
        if bad or not scrapes[0]:
            raise AssertionError(f"api wave: {scrapes[0]} scrapes, "
                                 f"not finite: {bad[:1]}")
        return got, wall, scrapes[0]

    (api, (got, wall, n_scrapes)), wave_counts = counted(lambda: run(wave))
    s1 = dict(eng.stats)
    results = [api_result(f"wave {i}", *got[i], API_SPECS[i][2],
                          API_SPECS[i][0]) for i in range(len(API_SPECS))]
    diff = {i: first_difference(r["tokens"], oracles[i].tokens)
            for i, r in enumerate(results)}
    ttft = [r["ttft_s"] * 1e3 for r in results]
    steps = max(s1["steps"] - s0["steps"], 1)
    rec.update(
        wave_wall_s=wall, wave_stats_scrapes=n_scrapes,
        wave_equal_solo=sum(d is None for d in diff.values()),
        wave_first_difference={i: d for i, d in diff.items()
                               if d is not None},
        ttft_p50_ms=float(np.percentile(ttft, 50)),
        ttft_p95_ms=float(np.percentile(ttft, 95)),
        decode_steps=s1["steps"] - s0["steps"],
        decode_step_ms=(s1["decode_s"] - s0["decode_s"]) / steps * 1e3,
        decode_host_ms=(s1["decode_host_s"] - s0["decode_host_s"])
        / steps * 1e3,
        mixed_plan_steps=s1["mixed_plan_steps"] - s0["mixed_plan_steps"])
    stats_after = api.stats()
    if (stats_after["server"]["requests_total"] != len(API_SPECS)
            or stats_after["server"]["open_completions"]):
        raise AssertionError(f"api stats after close: "
                             f"{stats_after['server']}")

    def disconnect(api):
        data = json.dumps({"prompt": reqs[4].prompt.tolist()[:16],
                           "max_new_tokens": 400, "stream": True}).encode()
        s = socket.create_connection((api.host, api.port), timeout=60)
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                  b"Content-Length: " + str(len(data)).encode()
                  + b"\r\n\r\n" + data)
        s.recv(4096)                # the headers, perhaps a first delta
        s.close()                   # gone mid-stream
        deadline = time.monotonic() + 60
        while True:
            with api.control():
                clean = (not api._live and eng.sched.done()
                         and not eng.sched._uids
                         and eng.kv.free_pages() == free0)
                generated = eng.stats["decode_tokens"]
            if clean:
                break
            if time.monotonic() > deadline:
                raise AssertionError("disconnect: pages or uid not released")
            time.sleep(0.01)
        status, ev = api_post(api, body(0))
        exact("after the disconnect", 0, api_result(
            "after the disconnect", status, ev, API_SPECS[0][2],
            API_SPECS[0][0]))
        return generated

    api, generated = counted(lambda: run(disconnect))[0]
    rec["disconnect_released"] = True
    rec["disconnect_decode_tokens_before_release"] = (
        generated - s1["decode_tokens"])
    rec["next_completion_equal_solo"] = True
    if eng.sched.slots.count(None) != eng.max_batch or eng.sched._uids:
        raise AssertionError("api_server: the engine was not handed back "
                             "drained")
    drained("api_server", eng)
    rec.update(graphs_captured_by_pump=eng.runner.stats["graphs"] - g0,
               launches=wave_counts, engine_drained=True,
               seconds_total=time.perf_counter() - t_start)
    emit(rec)
    return {"api_server_wave": (wave_counts, paged_kernels)}


@contextmanager
def decode_rows(eng):
    """Record the logits of every live row of each decode step while
    ``eng`` serves (a device copy, taken before the step's graph output is
    overwritten), as [(positions, logits of the live rows)]."""
    rows = []
    dec = eng.runner.decode

    def decode(tokens, pos, *a, **kw):
        logits, caches = dec(tokens, pos, *a, **kw)
        live = torch.from_numpy(np.flatnonzero(np.asarray(pos) >= 0))
        rows.append((np.array(pos), logits[live.to(logits.device)].clone()))
        return logits, caches
    eng.runner.decode = decode
    try:
        yield rows
    finally:
        del eng.runner.decode


def serve_lookahead(params, cfg, eng, device, t_start):
    """Phase 3f: serve's 8 requests with ``router_lookahead=True`` against
    the same engine settings with it off, in bf16 (``eng``; B3) and int8
    (B5, B6): equal tokens, every decode step's live logits rows bitwise
    equal (the kernels ignore the hint, and it touches no other value);
    the decode step's wall ms on and off, timed serves interleaved.
    Returns need."""
    from repro_torch import models
    from repro_torch.serving import Engine
    kernels_of = {"bf16": ("moe_gmm", "moe_decode", "flash_decode_paged"),
                  "int8": ("moe_gmm_quant", "moe_decode_quant",
                           "flash_decode_paged")}

    def make(dt, lookahead):
        return Engine(cfg, params, max_batch=8, max_len=512,
                      prefill_chunk=64, use_kernel=True, use_moe_decode=True,
                      expert_dtype=dt, router_lookahead=lookahead,
                      opts=models.ModelOpts(use_moe_kernel=True),
                      device=device)
    rec, need = {"phase": "serve_lookahead"}, {}
    for dt in ("bf16", "int8"):
        engines = {False: eng if dt == "bf16" else make(dt, False),
                   True: make(dt, True)}
        for e in engines.values():
            e.serve(requests(cfg, seed=0))          # captures every key
        step_ms, host_ms, res, rows, counts = {}, {}, {}, {}, {}
        for on in (False, True, True, False):       # timed, in turns
            e = engines[on]
            e.serve(requests(cfg, seed=0))
            r = serve_record(e)
            step_ms.setdefault(on, []).append(r["decode_step_ms"])
            host_ms.setdefault(on, []).append(r["decode_host_ms"])
        for on, e in engines.items():
            with decode_rows(e) as rows[on]:
                res[on], counts[on] = counted(
                    lambda: e.serve(requests(cfg, seed=0)))
            check_results(f"lookahead {dt} {on}", res[on], cfg, 32)
            need[f"lookahead_{dt}_{'on' if on else 'off'}"] = (
                counts[on], kernels_of[dt])
        same_tokens(f"lookahead {dt} on vs off", res[True], res[False])
        if len(rows[True]) != len(rows[False]):
            raise AssertionError(f"lookahead {dt}: {len(rows[True])} "
                                 f"decode steps against {len(rows[False])}")
        for (p1, l1), (p0, l0) in zip(rows[True], rows[False]):
            if not (np.array_equal(p1, p0) and torch.equal(l1, l0)):
                raise AssertionError(f"lookahead {dt}: decode logits differ "
                                     f"at positions {p1}")
        if counts[True] != counts[False]:
            raise AssertionError(f"lookahead {dt}: launches {counts[True]} "
                                 f"against {counts[False]}")
        on_ms = statistics.mean(step_ms[True])
        off_ms = statistics.mean(step_ms[False])
        rec[dt] = {"decode_step_ms_on": step_ms[True],
                   "decode_step_ms_off": step_ms[False],
                   "decode_host_ms_on": host_ms[True],
                   "decode_host_ms_off": host_ms[False],
                   "hint_cost_per_step_ms": on_ms - off_ms,
                   "hint_cost_share": on_ms / off_ms - 1.0,
                   "decode_steps": len(rows[True]),
                   "tokens_equal": True, "decode_logits_bitwise": True,
                   "launches": counts[True]}
        engines.pop(False)
        del engines, e
        torch.cuda.empty_cache()
    emit(dict(rec, seconds_total=time.perf_counter() - t_start))
    return need


@contextmanager
def forbid_plain():
    """Make every kernel's plain version raise on a tensor on the card
    while the block runs: the kernels' wrappers and the model's plain paths
    look them up by module attribute at each call."""
    import importlib
    from repro_torch import kernels
    saved = []
    for name in ("flash_attention", "flash_decode", "flash_decode_paged",
                 "moe_decode", "moe_ffn", "moe_gmm"):
        mod = importlib.import_module(f"{kernels.__name__}.{name}")
        for attr in dir(mod):
            fn = getattr(mod, attr)
            if attr.endswith("_plain") and callable(fn):
                def guard(*a, _fn=fn, _attr=attr, **kw):
                    if any(isinstance(t, torch.Tensor) and t.is_cuda
                           for t in list(a) + list(kw.values())):
                        raise AssertionError(f"{_attr} ran on the card")
                    return _fn(*a, **kw)
                saved.append((mod, attr, fn))
                setattr(mod, attr, guard)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def api_server_phase(cfg, device, t_start):
    """Phase 3g: the port's server entry point,
    ``repro_torch.launch.api_server.main``, in this process at full OLMoE
    width over a localhost socket (``--smoke``: a blocking, a streamed and
    a "lexi" completion and a stats scrape), with every kernel's plain
    version forbidden on the card.  The engine it builds must run the
    kernel options, launch B3 and B4 once a layer in every decode step
    (B1 in its chunks and plan search), and be freed, weights and graphs
    included, before ``main`` returns.  Returns need."""
    import gc
    import io
    import weakref
    from contextlib import redirect_stdout
    from repro_torch.launch import api_server
    seen = {}
    build, smoke = api_server.build_engine, api_server._smoke

    def build_engine(args):
        eng = build(args)
        seen.update(opts=eng.runner.opts, engine=weakref.ref(eng),
                    weights=weakref.ref(eng.runner.params["embed"]),
                    moe_layers=sum(s.kind == "attn_moe"
                                   for s in eng.cfg.pattern()),
                    layers=len(eng.cfg.pattern()))
        return eng

    def smoke_(api, vocab):
        seen["stats"] = smoke(api, vocab)
        seen["runner"] = dict(api.engine.runner.stats)
        return seen["stats"]
    argv = ["--arch", cfg.name, "--smoke", "--port", "0", "--host",
            "127.0.0.1", "--device", str(device), "--moe-impl", "gmm",
            "--use-kernel",
            "--use-moe-decode", "--use-moe-kernel", "--lexi-budget-frac",
            "0.5", "--max-batch", "8", "--max-len", "512"]
    api_server.build_engine, api_server._smoke = build_engine, smoke_
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with forbid_plain(), redirect_stdout(out):
            rc, counts = counted(lambda: api_server.main(argv))
    finally:
        api_server.build_engine, api_server._smoke = build, smoke
    wall = time.perf_counter() - t0
    gc.collect()
    if rc != 0 or "smoke ok" not in out.getvalue():
        raise AssertionError(f"api_server main returned {rc}: "
                             f"{out.getvalue()[-2000:]}")
    opts = seen["opts"]
    if not (opts.use_moe_kernel and opts.use_paged_kernel
            and opts.use_moe_decode_kernel):
        raise AssertionError(f"api_server: kernel options off: {opts}")
    if seen["engine"]() is not None or seen["weights"]() is not None:
        raise AssertionError("api_server: the engine or its weights outlived "
                             "main()")
    eng_stats = seen["stats"]["engine"]
    steps = int(eng_stats["steps"])
    per_step = {n: counts[n] for n in ("moe_decode", "flash_decode_paged")}
    if steps <= 0 or any(c != steps * (seen["moe_layers"] if n ==
                                       "moe_decode" else seen["layers"])
                         for n, c in per_step.items()):
        raise AssertionError(f"api_server: {per_step} launches over "
                             f"{steps} decode steps")
    emit({"phase": "api_server", "argv": argv, "wall_s": wall,
          "decode_steps": steps,
          "decode_step_ms": eng_stats["decode_s"] / steps * 1e3,
          "decode_host_ms": eng_stats["decode_host_s"] / steps * 1e3,
          "graphs_captured": seen["runner"]["graphs"],
          "capture_s": seen["runner"]["capture_s"],
          "throughput_tok_per_s": seen["stats"]["throughput_tok_per_s"],
          "requests_total": seen["stats"]["server"]["requests_total"],
          "launches": counts, "plain_on_card": 0, "engine_freed": True,
          "stdout": out.getvalue().splitlines(),
          "seconds_total": time.perf_counter() - t_start})
    return {"api_server": (counts, ("moe_gmm", "moe_decode",
                                    "flash_decode_paged"))}


# --------------------------------------------------------------------------- #
# phase 4: the paper's forward comparison
# --------------------------------------------------------------------------- #


def forward_phase(params, cfg, plan, device, eager_too: bool = False):
    """``launch.forward.compare`` on 4 x 512 tokens: ``loss_fn`` through
    the kernels, each model's forward a CUDA graph, for the baseline, the
    LExI plan and the two pruning baselines at 0.25; with ``eager_too`` the
    same forwards eagerly after that (fewer repeats), each cross-entropy
    within 1e-3 of the graphed one's.  Returns (record, launch counts of
    the graphed forwards)."""
    from repro_torch import kernels
    from repro_torch.launch.forward import compare, make_batch
    batch = make_batch(cfg, 4, 512, seed=4, device=device)
    kernels.reset_launch_counts()
    out = compare(params, cfg, plan, batch, prune_frac=0.25, reps=5)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for name, rec in out.items():
        if not np.isfinite(rec["xent"]) or not rec["graphed"]:
            raise AssertionError(f"forward {name}: xent {rec['xent']}, "
                                 f"graphed {rec['graphed']}")
    rec = {"phase": "forward", "batch": [4, 512], "models": out}
    if eager_too:
        eager = compare(params, cfg, plan, batch, prune_frac=0.25, reps=3,
                        graphs=False)
        for name, e in eager.items():
            if abs(e["xent"] - out[name]["xent"]) > 1e-3 * abs(e["xent"]):
                raise AssertionError(f"forward {name}: eager xent "
                                     f"{e['xent']} against graphed "
                                     f"{out[name]['xent']}")
        rec["eager_ms_median"] = {n: e["ms_median"] for n, e in eager.items()}
    for name, m in out.items():         # NAEE dynamic skipping's row
        if name.startswith("dyn_skip"):
            rec["dyn_skip"] = {
                "name": name, "ms_median": m["ms_median"],
                "ratio_to_baseline": (m["ms_median"]
                                      / out["baseline"]["ms_median"]),
                "expected_skip_rate": m["expected_skip_rate"],
                "xent": m["xent"]}
    if "dyn_skip" not in rec:
        raise AssertionError(f"forward: no dyn_skip row in {sorted(out)}")
    return rec, counts


# --------------------------------------------------------------------------- #
# phase 7: the config's own dense impl on the paged pool
# --------------------------------------------------------------------------- #


def serve_dense(params, cfg, plan, device, t_start):
    """The 8 requests on the paged pool through ``cfg``'s ``dense`` impl,
    baseline and ``plan``, and the baseline again on an eager engine
    (equal tokens, equal launches, equal drops): ``moe_ffn`` must launch
    once a layer in every chunk and every decode step,
    ``flash_decode_paged`` once a layer in every decode step, ``moe_gmm``
    and ``moe_decode`` never (dense is not rerouted, ``use_moe_decode``
    notwithstanding).  The token copies the capacity buffers dropped are
    summed on the card into two persistent counters, zeroed in place
    before each serve: the counting is hooked in before the first step,
    so every captured graph adds to the same counters at each replay.
    Returns {step: (counts, kernels the step must launch)}."""
    from repro_torch import models
    from repro_torch.models.moe import dense as dense_mod
    from repro_torch.serving import Engine
    assert cfg.moe_impl == "dense"
    slot_positions = dense_mod._slot_positions
    drops = {n: torch.zeros((), dtype=torch.long, device=device)
             for n in ("dropped", "copies")}

    def counting(idx, e, cap):
        pos, keep = slot_positions(idx, e, cap)
        drops["dropped"] += (~keep).sum()
        drops["copies"] += keep.numel()
        return pos, keep

    def make(graphs=True):
        eng = Engine(cfg, params, max_batch=8, max_len=512,
                     prefill_chunk=64, use_kernel=True, use_moe_decode=True,
                     opts=models.ModelOpts(use_moe_kernel=True),
                     device=device, graphs=graphs)
        eng.add_plan("lexi", plan)
        calls = {"chunk": 0, "decode": 0}
        for name in calls:
            attr = "chunk_prefill" if name == "chunk" else "decode"
            fn = getattr(eng.runner, attr)

            def step(*a, fn=fn, name=name, **kw):
                calls[name] += 1
                return fn(*a, **kw)
            setattr(eng.runner, attr, step)
        return eng, calls

    rec, need = {"phase": "serve_dense", "impl": cfg.moe_impl}, {}
    n = cfg.num_layers
    dense_mod._slot_positions = counting
    try:
        # the warm-up wave is the measured workload, so that the baseline
        # replays a graph captured for every key it steps through
        eng, calls = make()
        eng.serve(requests(cfg, seed=0))
        for tag, plan_name, graphs in (("baseline", None, True),
                                       ("lexi", "lexi", True),
                                       ("baseline_eager", None, False)):
            if not graphs:
                # the same warm-up wave: a pad query (position -1) attends
                # the stale bytes of its row's recycled pages, so its
                # routing, and the copies it drops, follow the pool's past
                del eng
                eng, calls = make(graphs=False)
                eng.serve(requests(cfg, seed=0))
            calls.update(chunk=0, decode=0)
            for t in drops.values():
                t.zero_()
            res, counts = counted(
                lambda: eng.serve(requests(cfg, seed=0), plan=plan_name))
            check_results(f"dense {tag}", res, cfg, max_new=32)
            if (counts["moe_gmm"] or counts["moe_decode"]
                    or counts["moe_ffn"] != n * (calls["chunk"]
                                                 + calls["decode"])
                    or counts["flash_decode_paged"] != n * calls["decode"]):
                raise AssertionError(f"dense {tag}: launches {counts} for "
                                     f"{calls['chunk']} chunk and "
                                     f"{calls['decode']} decode steps")
            need[f"dense_{tag}"] = (counts, ("moe_ffn", "flash_decode_paged"))
            rec[f"{tag}_tok_s"] = eng.throughput()
            rec[f"{tag}_stats"] = serve_record(eng)
            rec[f"{tag}_model_steps"] = dict(calls)
            rec[f"{tag}_copies"] = int(drops["copies"])
            rec[f"{tag}_dropped_copies"] = int(drops["dropped"])
            rec.setdefault("launches", {})[tag] = counts
            if tag == "baseline":
                base_res = res
            elif tag == "baseline_eager":
                same_tokens("dense baseline graphed vs eager", base_res, res)
                for k in ("copies", "dropped_copies"):
                    if rec[f"baseline_eager_{k}"] != rec[f"baseline_{k}"]:
                        raise AssertionError(f"dense baseline: {k} eager "
                                             f"{rec[f'baseline_eager_{k}']}"
                                             f" graphed {rec[f'baseline_{k}']}")
        del eng
    finally:
        dense_mod._slot_positions = slot_positions
    emit(dict(rec, seconds_total=time.perf_counter() - t_start))
    return need


# --------------------------------------------------------------------------- #
# phases 8-9: DeepSeek-V2-Lite (MLA)
# --------------------------------------------------------------------------- #

#: attention kernels an MLA model never launches: the reference drops
#: use_flash and use_flash_decode for MLA, and its paged kernel is B7
GQA_ATTENTION = ("flash_attention", "flash_decode", "flash_decode_paged")


def mla_checks(params, cfg, device):
    """``moe_gmm``, ``moe_decode`` and ``moe_ffn`` (on decode-shaped
    capacity buffers, C 4) at DeepSeek-V2-Lite's expert shapes (F 1408,
    top-6) and on an intra-pruned layer (F 1056, as forward_mla runs it),
    with ``moe_decode_quant`` and ``moe_gmm_quant`` in int8 and int4 there
    too, against their plain versions; then the kernel paths' logits
    against the plain paths' through the model cut to its dense layer and
    its first MoE layer -- a chunk prefill and a decode step on the paged
    pool, row by row to LOGITS_TOL, on ``gmm`` and on ``dense``.  The
    ``gmm`` kernel side must launch ``flash_decode_paged_mla`` once per
    layer in the decode step and no GQA attention kernel; the ``dense``
    one ``moe_ffn`` once a step and neither ``moe_gmm`` nor ``moe_decode``.
    Returns {kernel: {shape: numbers}} for the kernels line."""
    from repro_torch import models
    from repro_torch.core import intra_prune
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    x = torch.randn((512, cfg.d_model), generator=gen, device=device,
                    dtype=torch.bfloat16)
    x8 = x[:8].contiguous()
    cfg2 = cfg.with_(num_layers=2)
    params2 = dict(params, layers=params["layers"][:2])
    layer = params2["layers"][1]["moe"]
    pruned, cfg_p = intra_prune(params2, cfg2, 0.25)
    lay_p = pruned["layers"][1]["moe"]
    timing, shapes = {}, {}
    for lay, c in ((layer, cfg), (lay_p, cfg_p)):
        tag = f"_f{c.moe_d_ff}"
        _, ms, plain_ms, _, _, lib_ms, _ = check_moe_gmm(lay, c, x, flush,
                                                         tag=tag)
        timing["moe_gmm" + tag] = {"ms": ms, "plain_ms": plain_ms,
                                   "library_ms": lib_ms}
        for key, v in check_moe_decode(lay, c, x8, flush, tag).items():
            shapes.setdefault("moe_decode", {})[
                f"deepseek_f{c.moe_d_ff}_{key}"] = kernel_row(
                    "moe_decode", "", "", *v)
        sh = f"deepseek_decode_f{c.moe_d_ff}_c4"
        shapes.setdefault("moe_ffn", {})[sh] = kernel_row(
            "moe_ffn", "", "", *check_moe_ffn(lay, c, x8, flush, sh))
    for name, check, xx in (("moe_decode_quant", check_moe_decode_quant, x8),
                            ("moe_gmm_quant", check_moe_gmm_quant, x)):
        f = cfg_p.moe_d_ff
        for dt, v in check(lay_p, cfg_p, xx, flush, f"_f{f}").items():
            shapes.setdefault(name, {})[f"f{f}_{dt}"] = kernel_row(
                name, "", "", *v)
    shapes = {n: {sh: {k: r[k] for k in NESTED_KEYS if k in r}
                  for sh, r in rs.items()} for n, rs in shapes.items()}
    emit({"check": "deepseek_expert_kernels", "timing": timing,
          "shapes": shapes})
    del pruned, lay_p, flush

    dev = ref_inputs(cfg2, device)
    kern = models.ModelOpts(use_moe_kernel=True, use_paged_kernel=True,
                            use_moe_decode_kernel=True)
    got, counts = counted(lambda: paged_logits(params2, cfg2, kern, dev))
    want = paged_logits(params2, cfg2,
                        models.ModelOpts(use_moe_decode_kernel=True), dev)
    gate_logits("reference_logits_mla", got, want, launches={
        n: counts[n] for n in ("flash_decode_paged_mla", "moe_gmm",
                               "moe_decode") + GQA_ATTENTION})
    if (counts["flash_decode_paged_mla"] != cfg2.num_layers
            or any(counts[n] for n in GQA_ATTENTION)):
        raise AssertionError(f"MLA reference check launched {counts}")
    dense = cfg2.with_(moe_impl="dense")
    got, counts = counted(lambda: paged_logits(params2, dense, kern, dev))
    gate_logits("reference_logits_mla_dense", got,
                paged_logits(params2, dense, models.ModelOpts(), dev),
                launches={n: counts[n] for n in ("moe_ffn", "moe_gmm",
                                                 "moe_decode")})
    if counts["moe_ffn"] != 2 or counts["moe_gmm"] or counts["moe_decode"]:
        raise AssertionError(f"MLA dense reference check launched {counts}")
    return shapes


def serve_mla(params, cfg, device, t_start):
    """Phase 8: the 8 requests on the paged pool, a LExI plan searched on
    the card and served, the baseline on the contiguous layout.  Returns
    (the plan, {step: (launch counts, kernels the step must launch)})."""
    from repro_torch import models
    from repro_torch.core import optimize
    from repro_torch.serving import Engine
    max_new = 32
    opts = models.ModelOpts(use_moe_kernel=True)
    paged_kernels = ("flash_decode_paged_mla", "moe_gmm", "moe_decode")
    need, rec = {}, {"phase": "serve_mla"}

    def serve(eng, tag, names, plan_name=None):
        res, counts = counted(
            lambda: eng.serve(requests(cfg, seed=0), plan=plan_name))
        check_results(f"mla {tag}", res, cfg, max_new)
        need[f"mla_{tag}"] = (counts, names)
        rec[f"{tag}_tok_s"] = eng.throughput()
        rec[f"{tag}_stats"] = serve_record(eng)
        return res, counts

    def paged(graphs=True, **kw):
        return Engine(cfg, params, max_batch=8, max_len=512,
                      prefill_chunk=64, use_kernel=True, use_moe_decode=True,
                      opts=opts, device=device, graphs=graphs, **kw)
    eng = paged()
    eng.serve(requests(cfg, seed=0))    # warm-up: every key of the serve
    res, counts = serve(eng, "baseline", paged_kernels)
    rec["baseline_eager_stats"], c = eager_twin(
        "mla baseline", paged, requests(cfg, seed=0), res, counts)
    need["mla_baseline_eager"] = (c, paged_kernels)

    # the prefix workload, the cache off and then warm (the cold serve on
    # the cache-on engine captures its keys): the aligned hits' tokens
    # equal; B7 still once a layer in every decode step
    aligned = [i for i in range(16) if i not in HEAD_ONLY]
    prefix = {}
    pc = paged(prefix_cache=True)
    pc.serve(prefix_requests(cfg, 1))
    for tag, e in (("prefix_off", eng), ("prefix_warm", pc)):
        res_p, counts = counted(lambda: e.serve(prefix_requests(cfg, 1)))
        check_results(f"mla {tag}", res_p, cfg, max_new)
        need[f"mla_{tag}"] = (counts, paged_kernels)
        rec[f"{tag}_stats"] = dict(
            serve_record(e), prefix_hit_tokens=e.stats["prefix_hit_tokens"],
            cow_copies=e.stats["cow_copies"])
        if counts["flash_decode_paged_mla"] != (cfg.num_layers
                                                * e.stats["steps"]):
            raise AssertionError(f"mla {tag}: {counts} over "
                                 f"{e.stats['steps']} decode steps")
        prefix[tag] = res_p
    drained("mla prefix warm", pc)
    if rec["prefix_warm_stats"]["graphs_captured"]:
        raise AssertionError(f"mla prefix warm: {rec['prefix_warm_stats']}")
    same_tokens("mla prefix warm vs off (aligned hits)",
                only(prefix["prefix_warm"], aligned),
                only(prefix["prefix_off"], aligned))
    rec["prefix_head_only_agreement"] = agreement(
        only(prefix["prefix_warm"], HEAD_ONLY),
        only(prefix["prefix_off"], HEAD_ONLY))
    del pc
    budget = int(0.5 * cfg.num_moe_layers * cfg.moe_top_k)
    t0 = time.perf_counter()
    plan, counts = counted(lambda: optimize(
        params, cfg, budget, method="dp", n_iter=4, profile_batch=2,
        profile_seq=32, seed=0, device=device, use_kernel=True))
    rec.update(plan=list(plan.plan), budget=budget,
               optimize_s=time.perf_counter() - t0)
    need["mla_optimize"] = (counts, ("moe_gmm",))
    eng.add_plan("lexi", plan)
    serve(eng, "lexi", paged_kernels, "lexi")
    del eng
    torch.cuda.empty_cache()

    eng = Engine(cfg, params, max_batch=8, max_len=512,
                 cache_layout="contiguous", prefill_chunk=0,
                 use_moe_decode=True, opts=opts, device=device)
    eng.serve(requests(cfg, seed=0, n=2, max_new=4))      # warm-up wave
    serve(eng, "contiguous_baseline", ("moe_gmm", "moe_decode"))
    del eng
    torch.cuda.empty_cache()

    for step in ("mla_baseline", "mla_baseline_eager", "mla_lexi",
                 "mla_prefix_off", "mla_prefix_warm"):
        c = need[step][0]
        if (any(c[n] for n in GQA_ATTENTION)
                or c["flash_decode_paged_mla"] % cfg.num_layers):
            raise AssertionError(f"{step}: attention launches {c}")
    c = need["mla_contiguous_baseline"][0]
    if any(c[n] for n in GQA_ATTENTION + ("flash_decode_paged_mla",)):
        raise AssertionError(f"mla_contiguous_baseline: an attention "
                             f"kernel ran: {c}")
    rec["launches"] = {step[4:]: c for step, (c, _) in need.items()}
    rec["tokens_equal_graphed_vs_eager"] = True
    emit(dict(rec, seconds_total=time.perf_counter() - t_start))
    return plan, need


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core import optimize
    from repro_torch.kernels import _build
    from repro_torch.serving import Engine

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- phase 1: build -------------------------------------------------
    secs = _build.build_all()
    ptxas = {name: [line.strip() for line in log.splitlines()
                    if "registers" in line or "spill" in line
                    or "wgmma" in line]
             for name, log in _build.BUILD_LOG.items()}
    emit({"phase": "build", "seconds": secs,
          "kernels": list(_build.SOURCES), "ptxas": ptxas})

    # ---- model weights (full width and depth, bf16, drawn on the card) --
    # each config's own MoE impl is dense; the phases that serve the
    # sorted dropless dispatch run a gmm copy of it
    cfg = get_config("olmoe-1b-7b")
    cfg_mla = get_config("deepseek-v2-lite")
    assert cfg.moe_impl == cfg_mla.moe_impl == "dense"
    cfg_gmm = cfg.with_(moe_impl="gmm")
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    emit({"phase": "init", "seconds": time.perf_counter() - t0,
          "layers": cfg.num_layers, "d_model": cfg.d_model,
          "experts": cfg.num_experts, "top_k": cfg.moe_top_k,
          "params_gb": sum(t.numel() * t.element_size()
                           for lp in params["layers"] for t in
                           _leaves(lp)) / 1e9})

    # ---- phase 2: kernels against their plain versions ------------------
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    layer = params["layers"][0]["moe"]
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    x512 = torch.randn((512, cfg.d_model), generator=gen, device=device,
                       dtype=torch.bfloat16)
    x2048 = torch.randn((2048, cfg.d_model), generator=gen, device=device,
                        dtype=torch.bfloat16)
    gmm_row = kernel_row("moe_gmm", "src/repro_torch/csrc/moe_gmm.cu",
                         "src/repro/kernels/moe_gmm.py:84",
                         *check_moe_gmm(layer, cfg, x512, flush))
    gmm_row["max_abs_err"] = max(gmm_row["max_abs_err"],
                                 check_moe_gmm_edges(layer, cfg, x512))
    rows = {
        "moe_gmm": gmm_row,
        # 8 tokens at top-8 first, then at k 2; each shape carries its
        # distinct routed experts and the bytes they make
        "moe_decode": nested_row(
            "moe_decode", "src/repro_torch/csrc/moe_decode.cu",
            "src/repro/kernels/moe_decode.py:82",
            {f"olmoe_{key}": v for key, v in check_moe_decode(
                layer, cfg, x512[:8].contiguous(), flush).items()},
            "shapes"),
        # the OLMoE check first, then GQA under a window, one row of 512
        # positions, rows ending one page past a chunk boundary
        "flash_decode_paged": nested_row(
            "flash_decode_paged", "src/repro_torch/csrc/flash_decode_paged.cu",
            "src/repro/kernels/flash_decode_paged.py:107",
            check_flash_decode_paged(cfg, flush, device), "shapes"),
        "flash_attention": kernel_row(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:74",
            *check_flash_attention(cfg, flush, device)),
        # the OLMoE check first, then GQA under a window, one row of 512
        # positions, rows at the edges of the 32-slot chunks
        "flash_decode": nested_row(
            "flash_decode", "src/repro_torch/csrc/flash_decode.cu",
            "src/repro/kernels/flash_decode.py:73",
            check_flash_decode(cfg, flush, device), "shapes"),
        # int8 first; no single PyTorch call dequantizes and runs the
        # SwiGLU, so library_ms is null: sibling_ms is the bf16 kernel (B1,
        # B3) on the same routing, timed in the same turns
        "moe_gmm_quant": nested_row(
            "moe_gmm_quant", "src/repro_torch/csrc/moe_gmm_quant.cu",
            "src/repro/kernels/moe_gmm.py:190",
            check_moe_gmm_quant(layer, cfg, x512, flush), "dtypes"),
        "moe_decode_quant": nested_row(
            "moe_decode_quant", "src/repro_torch/csrc/moe_decode_quant.cu",
            "src/repro/kernels/moe_decode.py:257",
            check_moe_decode_quant(layer, cfg, x512[:8].contiguous(), flush),
            "dtypes"),
        # the DeepSeek check first, then one row of 512 positions
        "flash_decode_paged_mla": nested_row(
            "flash_decode_paged_mla",
            "src/repro_torch/csrc/flash_decode_paged_mla.cu",
            "src/repro/kernels/flash_decode_paged.py:199",
            check_flash_decode_paged_mla(cfg_mla, flush, device), "shapes"),
        # the forward's 4 x 512 tokens, a serve chunk's 8 x 64, a decode
        # step's 8 slots, each at top-8 and capacity factor 1.25
        "moe_ffn": nested_row(
            "moe_ffn", "src/repro_torch/csrc/moe_ffn.cu",
            "src/repro/kernels/moe_ffn.py:63",
            {sh: check_moe_ffn(layer, cfg, xx, flush, sh) for sh, xx in (
                ("olmoe_forward_c320", x2048),
                ("olmoe_chunk_c80", x2048[:512]),
                ("olmoe_decode_c4", x2048[:8]))}, "shapes"),
    }
    del flush
    emit({"phase": "kernels", "ok": True,
          "timing": {n: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                         "bound_ms": r["bound_ms"],
                         "library_ms": r["library_ms"],
                         **{k: r[k] for k in ("dtypes", "shapes") if k in r}}
                     for n, r in rows.items()}})

    # ---- phase 3: serve baseline, search a plan, serve the plan ---------
    reference_check(params, cfg_gmm, device)
    max_new = 32

    def paged_engine(graphs=True):
        return Engine(cfg_gmm, params, max_batch=8, max_len=512,
                      prefill_chunk=64, use_kernel=True, use_moe_decode=True,
                      opts=models.ModelOpts(use_moe_kernel=True),
                      device=device, graphs=graphs)
    eng = paged_engine()
    # the warm-up wave is the measured workload, so that the measured
    # serve replays a graph captured for every key it steps through
    eng.serve(requests(cfg, seed=0))
    warm = serve_record(eng)
    with first_token_rows(eng) as rows_base:
        res_base, base_counts = counted(
            lambda: eng.serve(requests(cfg, seed=0)))
    check_results("baseline", res_base, cfg, max_new)
    base_rec = serve_record(eng)
    eager_base, eager_base_counts = eager_twin(
        "baseline", paged_engine, requests(cfg, seed=0), res_base,
        base_counts)

    budget = int(0.5 * cfg.num_moe_layers * cfg.moe_top_k)
    t0 = time.perf_counter()
    plan, opt_counts = counted(lambda: optimize(
        params, cfg_gmm, budget, method="dp", n_iter=4, profile_batch=2,
        profile_seq=32, seed=0, device=device, use_kernel=True))
    opt_s = time.perf_counter() - t0
    eng.add_plan("lexi", plan)
    eng.serve(requests(cfg, seed=0), plan="lexi")     # captures its keys
    lexi_warm = serve_record(eng)
    res_lexi, lexi_counts = counted(
        lambda: eng.serve(requests(cfg, seed=0), plan="lexi"))
    check_results("lexi", res_lexi, cfg, max_new)
    lexi_rec = serve_record(eng)

    def paged_lexi_engine(graphs=True):
        e = paged_engine(graphs)
        e.add_plan("lexi", plan)
        return e
    eager_lexi, eager_lexi_counts = eager_twin(
        "lexi", paged_lexi_engine, requests(cfg, seed=0), res_lexi,
        lexi_counts, plan="lexi")

    # the same 8 requests, alternating base and the plan, in one wave:
    # every mixed step runs the bucketed-k graph; each request's tokens
    # must equal its single-plan serve's
    mix = ["base" if i % 2 == 0 else "lexi" for i in range(8)]
    single = [(res_base if p == "base" else res_lexi)[i]
              for i, p in enumerate(mix)]
    same_tokens("serve_mixed warm-up",               # captures the buckets
                eng.serve(requests(cfg, seed=0, plans=mix)), single)
    mix_warm = serve_record(eng)
    res_mix, mix_counts = counted(
        lambda: eng.serve(requests(cfg, seed=0, plans=mix)))
    same_tokens("serve_mixed", res_mix, single)
    mix_rec = serve_record(eng)
    buckets = [k for k in eng.runner.compiled_specializations()
               if isinstance(k[0], tuple) and k[0][0] == "bucket"]
    if mix_rec["mixed_plan_steps"] <= 0 or not buckets:
        raise AssertionError(f"serve_mixed: {mix_rec['mixed_plan_steps']} "
                             f"mixed steps, bucket keys {buckets}")
    paged_kernels = ("moe_gmm", "moe_decode", "flash_decode_paged")
    need = {"baseline": (base_counts, paged_kernels),
            "baseline_eager": (eager_base_counts, paged_kernels),
            "optimize": (opt_counts, ("moe_gmm",)),
            "lexi": (lexi_counts, paged_kernels),
            "lexi_eager": (eager_lexi_counts, paged_kernels),
            "mixed": (mix_counts, paged_kernels)}
    emit({"phase": "serve", "baseline_tok_s": base_rec["tok_s"],
          "lexi_tok_s": lexi_rec["tok_s"], "plan": list(plan.plan),
          "budget": budget, "optimize_s": opt_s,
          "warmup_stats": warm, "baseline_stats": base_rec,
          "baseline_eager_stats": eager_base, "lexi_warmup_stats": lexi_warm,
          "lexi_stats": lexi_rec,
          "lexi_eager_stats": eager_lexi,
          "tokens_equal_graphed_vs_eager": True,
          "launches": {"baseline": base_counts, "optimize": opt_counts,
                       "lexi": lexi_counts},
          "seconds_total": time.perf_counter() - t_start})
    emit({"phase": "serve_mixed", "plans": mix, "warmup_stats": mix_warm,
          "stats": mix_rec,
          "bucket_keys": [list(map(str, k)) for k in buckets],
          "tokens_equal_single_plan_serves": True, "launches": mix_counts,
          "seconds_total": time.perf_counter() - t_start})

    # ---- phases 3b-3d: prefix cache, plan ladder, open-loop arrivals -----
    need.update(serve_prefix(params, cfg_gmm, eng, device, t_start))
    res_base16, ladder_need = serve_ladder(params, cfg_gmm, eng, plan,
                                           device, t_start)
    need.update(ladder_need)
    need.update(serve_open_loop(params, cfg_gmm, res_base16, device,
                                t_start))

    # ---- phases 3e-3g: the HTTP front end, router lookahead -------------
    need.update(api_server_checks(eng, cfg_gmm, device, t_start))
    need.update(serve_lookahead(params, cfg_gmm, eng, device, t_start))
    del eng
    torch.cuda.empty_cache()
    need.update(api_server_phase(cfg, device, t_start))

    # ---- phase 4: the paper's forward comparison ------------------------
    rec, fwd_counts = forward_phase(params, cfg, plan, device,
                                    eager_too=True)
    need["forward"] = (fwd_counts, ("moe_ffn", "moe_gmm", "flash_attention"))
    emit(dict(rec, launches=fwd_counts,
              seconds_total=time.perf_counter() - t_start))

    # ---- phase 5: contiguous layout, whole-prompt prefill ---------------
    def contiguous_engine(graphs=True):
        return Engine(cfg_gmm, params, max_batch=8, max_len=512,
                      cache_layout="contiguous", prefill_chunk=0,
                      use_moe_decode=True, opts=models.ModelOpts(
                          use_flash=True, use_flash_decode=True,
                          use_moe_kernel=True), device=device, graphs=graphs)
    eng = contiguous_engine()
    eng.serve(requests(cfg, seed=0, n=2, max_new=4))      # warm-up wave
    eng.add_plan("lexi", plan)
    contiguous_kernels = ("moe_gmm", "moe_decode", "flash_attention",
                          "flash_decode")
    rec = {"phase": "serve_contiguous"}
    for tag, plan_name in (("baseline", None), ("lexi", "lexi")):
        res, counts = counted(
            lambda: eng.serve(requests(cfg, seed=0), plan=plan_name))
        check_results(f"contiguous {tag}", res, cfg, max_new)
        need[f"contiguous_{tag}"] = (counts, contiguous_kernels)
        rec[f"{tag}_tok_s"] = eng.throughput()
        rec[f"{tag}_stats"] = serve_record(eng)
        rec.setdefault("launches", {})[tag] = counts
        if tag == "baseline":
            rec["baseline_eager_stats"], c = eager_twin(
                "contiguous baseline", contiguous_engine,
                requests(cfg, seed=0), res, counts)
            need["contiguous_baseline_eager"] = (c, contiguous_kernels)
    emit(dict(rec, seconds_total=time.perf_counter() - t_start))
    del eng
    torch.cuda.empty_cache()

    # ---- phase 5b: contiguous layout, chunked prefill -------------------
    need.update(serve_contiguous_chunked(params, cfg_gmm, rows_base,
                                         res_base, device, t_start))
    torch.cuda.empty_cache()

    # ---- phase 6: quantized experts on the paged pool -------------------
    from repro_torch.models.moe import QUANT_DTYPES
    quant_kernels = ("moe_gmm_quant", "moe_decode_quant",
                     "flash_decode_paged")
    for dt in QUANT_DTYPES:
        eng = Engine(cfg_gmm, params, max_batch=8, max_len=512,
                     prefill_chunk=64, use_kernel=True, use_moe_decode=True,
                     expert_dtype=dt,
                     opts=models.ModelOpts(use_moe_kernel=True),
                     device=device)
        eng.serve(requests(cfg, seed=0, n=2, max_new=4))  # warm-up wave
        eng.add_plan("lexi", plan)
        moe = [lp["moe"] for lp in eng.runner.params["layers"]]
        rec = {"phase": "serve_quant", "expert_dtype": dt,
               "expert_gb": sum(m[w].numel() * m[w].element_size()
                                for m in moe for w in ("w1", "w2")) / 1e9,
               "scale_mb": sum(m[w].numel() * m[w].element_size()
                               for m in moe
                               for w in ("w1_scale", "w2_scale")) / 1e6,
               "bf16_expert_gb": sum(
                   lp["moe"][w].numel() * lp["moe"][w].element_size()
                   for lp in params["layers"] for w in ("w1", "w2")) / 1e9}
        for tag, plan_name in (("baseline", None), ("lexi", "lexi")):
            res, counts = counted(
                lambda: eng.serve(requests(cfg, seed=0), plan=plan_name))
            check_results(f"{dt} {tag}", res, cfg, max_new)
            for n in ("moe_gmm", "moe_decode"):      # no bf16 expert path
                if counts[n]:
                    raise AssertionError(f"{dt} {tag}: the bf16 kernel {n} "
                                         f"ran {counts[n]} times")
            need[f"{dt}_{tag}"] = (counts, quant_kernels)
            rec[f"{tag}_tok_s"] = eng.throughput()
            rec[f"{tag}_stats"] = serve_record(eng)
            rec.setdefault("launches", {})[tag] = counts
        emit(dict(rec, seconds_total=time.perf_counter() - t_start))
        del eng, moe
        torch.cuda.empty_cache()

    # ---- phase 7: the config's own dense impl on the paged pool ---------
    need.update(serve_dense(params, cfg, plan, device, t_start))
    torch.cuda.empty_cache()

    # ---- phases 8-9: DeepSeek-V2-Lite (MLA), the OLMoE weights freed -----
    del params, layer, x512, x2048
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = models.init_params(cfg_mla, seed=0, device=device)
    torch.cuda.synchronize()
    emit({"phase": "init_mla", "seconds": time.perf_counter() - t0,
          "layers": cfg_mla.num_layers, "d_model": cfg_mla.d_model,
          "kinds": [s.kind for s in cfg_mla.pattern()[:2]],
          "experts": cfg_mla.num_experts, "top_k": cfg_mla.moe_top_k,
          "params_gb": sum(t.numel() * t.element_size()
                           for t in _leaves(params)) / 1e9,
          "kv_bytes_per_token": cfg_mla.num_layers * 2 * (
              cfg_mla.kv_lora_rank + cfg_mla.qk_rope_head_dim),
          "olmoe_kv_bytes_per_token": cfg.num_layers * 2 * 2 * (
              cfg.num_kv_heads * cfg.head_dim_)})
    mla_gmm = cfg_mla.with_(moe_impl="gmm")
    for name, per_shape in mla_checks(params, mla_gmm, device).items():
        rows[name].setdefault("shapes", {}).update(per_shape)
    plan, mla_need = serve_mla(params, mla_gmm, device, t_start)
    need.update(mla_need)
    rec, fwd_counts = forward_phase(params, cfg_mla, plan, device)
    if any(fwd_counts[n] for n in GQA_ATTENTION):
        raise AssertionError(f"forward_mla: attention kernels {fwd_counts}")
    need["forward_mla"] = (fwd_counts, ("moe_ffn", "moe_gmm"))
    emit(dict(rec, phase="forward_mla", launches=fwd_counts,
              seconds_total=time.perf_counter() - t_start))
    del params
    torch.cuda.empty_cache()

    for step, (counts, names) in need.items():
        for n in names:
            if counts[n] <= 0:
                raise AssertionError(f"{step}: kernel {n} was never launched")
    for n, r in rows.items():
        r["launches"] = sum(c[n] for c, _ in need.values())
    emit({"phase": "done", "steps_checked": len(need),
          "seconds_total": time.perf_counter() - t_start})
    emit({"kernels": list(rows.values())})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
