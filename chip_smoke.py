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
              64-column table view; the four attention kernels also at
              the families' head shapes (FAMILY_DECODE: B4 and B8 at g 16,
              5 and 8 with hd 128, at g 4 with hd 80 under a window and
              at zamba2's 32 heads of 64;
              B2 at danube's hd 80; B7 at MiniCPM3's 40 heads, r 256, dr
              32), every row of each held bit for bit alone against the
              batch; every check prints a sha256 digest of its output
              (``digest``: equal digests across checkouts mean equal
              bits; see ``--digests`` below);
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
              interleaved).  Then the f32 kernels (``f32_kernel_checks``,
              C12): B1, B3 and B9 on f32 experts, B6 and B5 on f32 tokens
              and int8 / int4 experts, and B2, B8 and B4 on f32 q, K and
              V, at the reduced OLMoE config's shapes (d 128, 4 heads of
              32, 8 experts at top-2, F 64; GQA under a window too) and at
              full-width OLMoE's (B9 at C 4 also against f64 beside the
              f32 summation bound, ``f64_witness``, C13; B1 and B6 also on
              the first 64 tokens, with the rows each computes, B1 beside
              the library's call on the real rows alone), B6 and B5 at
              llama4-scout's F 8192, B7 on f32 latents at the reduced
              DeepSeek config's (4 heads, r 32, dr 16), DeepSeek-V2-Lite's
              and MiniCPM3-4B's widths, each held elementwise to
              its plain version at F32_TOL (the reference's own f32
              tolerance), its cost on the card equal to its ``meta``
              route's, B8's, B4's and B7's rows bit for bit alone against
              the batch, timed beside the plain version, the bf16 kernel on
              the same inputs rounded to bf16 (``sibling_ms``) and the
              library call; the rows' ``f32_*`` sub-entries under
              ``shapes``; and B2's bf16 body at hd 32 to ROW_TOL.
3. serve   -- OLMoE-1B-7B at full width and depth (16 layers, d 2048, 64
              experts, top-8), bf16, random weights drawn on the card from a
              seed: serve 8 requests on the paged pool with chunked
              prefill (a warm-up wave of the same requests first, so the
              measured serve replays a graph for every step), search a
              LExI plan on the card (Alg. 1 through the ``moe_gmm`` kernel,
              a CUDA graph a MoE layer, then the DP search; then Alg. 1
              again with SENS_ITERS draws graphed, eager, graphed: one
              ``sensitivity`` line, every table bit for bit the eager one,
              seconds each), register it and serve again (after a
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
7b. serve_f32 -- OLMoE-1B-7B at full width and depth in f32 (the bf16
              weights cast in place, 27.7 GB; TF32 off for cuBLAS and
              cuDNN, both flags printed): the 8 requests paged on ``gmm``
              (B1, B3, B4), contiguous with whole prompts (B2, B8, B1,
              B3), paged on ``dense`` (B9, B4; every engine after the
              same warm-up wave) and paged on ``gmm`` with int8 and int4
              experts (B6, B5, B4), each graphed, with an eager twin
              (equal tokens and launches) and on the plain f32 paths (the
              first-token rows' distances from the plain f32 path's
              printed, the bf16 kernel path's of phases 3, 5 and 7
              beside; contiguous and dense: where the eager twin's routing
              first splits from an eager plain serve's, warm-up waves
              included, with the router's gap there, C13); then each
              serve through the first
              F32_GATE_LAYERS layers on the f32 kernels, the plain f32
              paths and the bf16 kernels: the f32 kernel path's
              first-token logits within F32_LOGITS_TOL of the plain f32
              path's and at most F32_RATIO times as far from them as the
              bf16 kernel path's; then Fig. 4's ``gmm`` rows (baseline
              and plan) through B1 and B2 as CUDA graphs, their
              cross-entropy within RECIPE_TOL of the plain f32 paths'.
    reduced_f32 -- the reduced OLMoE and DeepSeek-V2-Lite configs (f32)
              through the entry points in this process:
              ``launch/serve.py`` on OLMoE on ``dense`` (B9, B4), on
              ``gmm`` with the fused decode and a plan (B1, B3, B4),
              contiguous with whole prompts (B2, B8, B9), on ``gmm`` with
              int8 and int4 experts (B6, B5, B4), on DeepSeek paged (B1,
              B3, B7 at r 32, dr 16) and with int4 experts (B6, B5, B7),
              and ``launch/serve_lexi.py`` (B1, B2, B3, B4), again with
              int8 experts (B6, B5, B4, B2).
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
9a. serve_f32_mla -- DeepSeek-V2-Lite at full depth with every weight
              but the routed experts cast to f32 in place and the experts
              quantized to int8 at load: the 8 requests paged on ``gmm``
              (B6, B5, B7 on an f32 latent pool) as phase 7b serves them,
              gated through its dense first layer and first MoE layer;
              the phase's peak printed.
9b. families -- the DeepSeek weights freed, each of
              ``repro_torch.configs.FAMILIES`` in turn at full width, bf16,
              random weights drawn on the card (qwen3-moe-235b-a22b and
              llama4-scout-17b-a16e cut to FAMILY_LAYERS = 8 layers;
              qwen3-32b, h2o-danube-1.8b, minicpm3-4b, olmo-1b and
              pixtral-12b at full depth),
              its weights, engines and graphs freed before the next: B1,
              B3, B9, and B5 and B6 in int8 and int4, at the MoE configs'
              expert shapes (sub-entries of their rows); the kernel
              paths' logits against the plain paths'
              (``family_reference``: a chunk and a decode step on
              the paged pool, for GQA a whole prompt and a decode step on
              the contiguous cache); the 8 requests (FAMILY_NEW tokens
              each) on the paged pool through the config's own ``dense``,
              graphed, with an eager twin; danube (its window cut to
              FAMILY_WINDOW, under the prompts), qwen3-32b, olmo and
              pixtral on the contiguous layout too (``flash_attention``,
              ``flash_decode``, no plain attention); pixtral's VLM path at
              full depth (``prefix_check``: 1024 random patch embeddings
              and a 64-token prompt prefilled through ``flash_attention``,
              a decode step through ``flash_decode``, against the plain
              paths: at full depth within WITNESS_RATIO of an f32
              witness, through the first layer within LOGITS_TOL);
              qwen3-moe's LExI plan at a 50 % budget
              served and a mixed wave, each with an eager twin of the same
              history; llama4-scout's plan asserted to be (1,) * 8, and
              its 8 requests served again with int8, then int4 experts
              (FAMILY_QUANT: quantized at load on ``gmm``, graphed, an
              eager twin's tokens and launches equal, ``moe_gmm_quant``
              and ``moe_decode_quant`` launched, no bf16 expert kernel;
              B5's pass 2 in two chunks of h rows at F 8192).  One
              ``families`` line a config (layers, params_gb,
              kv_bytes_per_token, peak_gb, launches).
9c. ssm_encdec -- mamba2-780m (48 Mamba2 layers), zamba2-1.2b (32 Mamba2
              layers and one shared attention block applied 6 times) and
              whisper-base (6 + 6 layers, 1500 frames) in turn at full
              width and depth, bf16, random weights drawn on the card,
              each freed before the next: for the two SSM stacks,
              prefill-then-decode logits against a train-mode forward
              (``ssm_reference``: at full depth within WITNESS_RATIO of
              an f32 witness, through the first 6 layers within
              LOGITS_TOL), then the 8 requests (32-256 prompt
              tokens: never over the SSD chunk) on the contiguous engine,
              whole prompts, graphed, with an eager twin (tokens, launches
              and every decode logits row bit for bit equal) and a steady
              wave; zamba2's shared attention through ``flash_attention``
              (6 a prefill) and ``flash_decode`` (6 a decode step), no
              plain attention; mamba2 launches no kernel.  For whisper,
              ``prefill_fn`` of 8 rows of 1500 random frames and 4 prompt
              tokens, 16 greedy ``decode_fn`` steps eagerly and from one
              CUDA graph (bit for bit), held to a train-mode decoder pass;
              no kernel (the reference runs none there).  One
              ``ssm_encdec`` line a config (layers, params_gb, state or
              KV bytes, peak_gb, decode step ms graphed and eager,
              launches).
10. train  -- the DeepSeek weights freed, OLMoE-1B-7B at full width and
              half depth (TRAIN_LAYERS: 16 layers of train state would
              not fit), bf16, random weights from seed 0, trained
              ``training.train`` on its own ``dense`` impl through the
              plain paths: 6 AdamW steps on 4 x 512 tokens of the
              Zipf-Markov stream (loss, grad norm and wall ms each),
              twice eagerly and once as a CUDA graph (the default: the
              first step eager, five replays), the graphed run held to
              the eager one by ``train_gate`` (within WITNESS_RATIO of the
              two eager runs' distance: bits where they are equal), each
              run's peak memory; forward+backward and the optimizer timed
              apart on the device, eagerly and each as a graph, tokens/s,
              the data pipeline's seconds a batch, peak memory against 12
              B a parameter; a step with ``use_moe_kernel`` refused (no
              kernel has a backward); held-out perplexity on the trained
              weights through ``moe_ffn`` and ``flash_attention``,
              graphed (one graph for the batch shape) bit for bit the
              eager one and within LOG_PPL_TOL (log ppl) of the plain
              paths' -- this phase's kernel path; one eval batch timed
              graphed and eager; one
              step under ``remat="full"`` from the same init: the first
              step's loss bit for bit, its forward+backward at a lower
              peak.
11. train_quality -- ``launch/serve_lexi.py``'s recipe (a 4-layer
              OLMoE-family model, f32) trained 200 steps on the plain
              paths: Alg. 1 through B1 and on the plain paths, the tables
              within RECIPE_TOL and both DP plans printed; held-out ppl
              through B1 and B2 of the untrained model, the baseline
              (within RECIPE_TOL of the plain paths'), the LExI plan at a
              50 % budget, ``inter_prune`` and ``intra_prune`` at 0.25
              (Fig. 4's quality side on trained weights); the trained
              baseline below 0.8x the untrained ppl; baseline and plan
              served through one graphed engine on the kernels (tok/s).
12. train_resume -- in a child process with deterministic algorithms:
              the recipe for 20 steps, checkpointed every 5, killed at
              step 12 and resumed, equals the uninterrupted run bit for
              bit; then ``python -m repro_torch.launch.train --arch
              olmoe-1b-7b --reduced --steps 20 --eval --device cuda``
              exits 0.
13. mesh   -- tensor, expert and data parallelism through the entry
              points on a (1, 1) ("data", "model") mesh bound to a
              one-rank NCCL group (``file://`` rendezvous; destroyed at
              the end of the phase), full-depth OLMoE-1B-7B (16 layers,
              bf16, random weights from seed 0, the rank's blocks of the
              rules' full specs, FSDP on), every kernel's plain version
              forbidden on the card: B9 first at the path's new shape
              ([64, 160, 2048], the first of two a2a chunks) against its
              plain version; (a) ``loss_fn`` and prefill logits of 4 x 512
              tokens through tensor parallelism and ``ep_a2a`` at
              ``a2a_chunks`` 1 and 2, and under phase 3's LExI plan, bit
              for bit equal to ``dense`` with no mesh (B2, B9 both sides;
              the all-to-all operand bytes of a forward recorded,
              ``analysis.record``, the plan's smaller); ``prefill_fn`` and
              MESH_DECODE_STEPS ``decode_fn`` steps through ``ep_psum``
              with ``decode_kv_seq_shard``, bit for bit equal to the same
              steps with no mesh; (b) one ``make_train_step(mesh=)`` step
              of a depth-4 OLMoE with ``fsdp_params``, ZeRO-1 and
              ``remat_chunk`` 2, bit for bit equal to the no-mesh step
              with per-layer remat (loss and every leaf), then
              MESH_TRAIN_STEPS steps eagerly and as a CUDA graph (NCCL
              inside), held to ``train_gate``, collectives equal; (c)
              ``Engine(mesh=)`` serving 8 requests paged in two waves
              eagerly (``graphs=False``) and with ``graphs`` at its
              default (CUDA graphs with their NCCL collectives: the first
              wave captures, the second replays; ``ep_a2a`` chunks,
              ``ep_psum`` decode; B4, B9), each wave's greedy tokens
              equal to each other and to the no-mesh eager engine's same
              wave, the graphed waves' collectives and launches the eager
              waves'; (e)
              DeepSeek-V2-Lite at full width cut to MLA_MESH's layers: a
              chunk prefill into a paged pool and one decode step under
              ``decode_kv_seq_shard`` (the MLA layers attend their whole
              latent cache: B7, ``ep_a2a`` / ``ep_psum``'s B9), bit for
              bit the same steps with no mesh; (d) B2, B4, B7,
              B8 and B9 at the shapes a rank of a 16-way ``model`` axis
              gives them in the assigned configs (``tp_kernel_checks``:
              its heads of the projections, a head slice of a whole KV
              cache where the kv heads do not split, its expert slice),
              against their plain versions to ROW_TOL, B4 / B7 / B8 rows
              bitwise alone against the batch, timed beside their
              bounds.  One ``mesh`` line, with seconds and the card.
14. dryrun -- the production dry run (``launch/dryrun.py``): (a) on the
              ``meta`` device, on this host's CPU, the cells of
              DRYRUN_CELLS at 16 x 16 (one at 2 x 16 x 16), each OK, a
              ``dryrun_cell`` check line each with its roofline terms,
              dominant term and peak GB a rank; (b) on a one-rank NCCL
              (1, 1) mesh, full-depth OLMoE-1B-7B through the dry run's
              ``build_cell``, with the serving path's kernels: a prefill of
              4 x 512 (B2, B9) and a decode step of 8 rows over 512 slots
              (B8, B9), then a train step of 4 x 512 at
              DRYRUN_TRAIN_LAYERS layers (``ep_a2a``, remat on every
              layer; plain paths), each counted on ``meta`` (the mesh
              placed) and on the card (``analysis.counters.count``): FLOPs,
              aten and kernel bytes, collective bytes and calls by kind
              (the backward's included), and kernel calls equal; the train
              step's all-to-alls three per forward call's; the step
              (CUDA events, median of DRYRUN_REPS) at least its bound
              from the meta counts; the card's peak over the meta peak
              inside DRYRUN_PEAK_BAND; and whisper-base's prefill and
              decode logits on the mesh bit for bit its no-mesh logits;
              (b') DRYRUN_BF16_STEP, the train step in
              ``attn_compute_dtype="bf16_accum32"``, held as (b) holds a
              train step; (b'') ``_sdpa`` in ``"bf16_accum32"`` at
              OLMoE's heads over SDPA_BF16_CHECK on the card (``bmm``'s
              ``out_dtype`` form) against the CPU route on the same bf16
              inputs, row by row to ROW_TOL (its check line carries the
              largest absolute error); (b-f32) the prefill and decode
              steps of (b) in f32 at DRYRUN_F32_LAYERS layers (B2, B8, B9
              on f32 operands), held as (b) holds a step.  One ``dryrun``
              line.

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
each step of phases 3-10 (9c included), 13 and 14; each step must launch the
kernels it runs.  A
small reference check holds the kernel paths' logits against the plain
paths' on the same inputs, row by row, with bf16 experts on ``gmm`` and
on ``dense``, with int8 and int4 experts, and on DeepSeek-V2-Lite.  Then
it prints the
``kernels`` summary line (launches summed over every step), the card's
name and power limit, and as the last line ``{"ok": true, "device":
{...}}``.  Without a CUDA device it exits 1 and prints no result.

    python3 chip_smoke.py --digests [DIR]

runs only the four attention kernels' checks of phase 2 (B2, B8 and B4 on
OLMoE-1B-7B's widths and the families', B7 on DeepSeek-V2-Lite's and
MiniCPM3-4B's; B2, B8 and B4 in f32 at OLMoE's widths; B7 on f32
latents at F32_MLA_SHAPES), B6 and B5 on f32 tokens at the reduced
OLMoE layer and B5's at DIGEST_QUANT, untimed, on the ``repro_torch`` of
``DIR/src`` (default:
this checkout; its kernels build into ``DIR/build``), and prints as its
last line ``{"digests": {check: digest}, "refused": {check function:
message}}``.  Each kernel's newer shapes come after its older ones, so a
package that refuses a shape (an older checkout) has digested every shape
it takes; equal digests of a check under two packages mean equal bits.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from functools import partial
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
    before every call.  No ``flush`` (``--digests``): untimed, Nones."""
    if flush is None:
        return [None] * len(fns)
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for r in range(reps):
        for i in range(len(fns)):
            j = (i + r) % len(fns)
            times[j].append(_time_once(fns[j], flush))
    return [statistics.median(t) for t in times]


#: every check's output digest, by check name (``--digests`` prints them)
DIGESTS: dict = {}


def digest(t: torch.Tensor) -> str:
    """sha256 (16 hex digits) of a tensor's bytes: equal digests of one
    check's output on two checkouts mean equal bits (the inputs come from
    fixed seeds)."""
    return hashlib.sha256(t.detach().contiguous().view(-1).view(torch.uint8)
                          .cpu().numpy().tobytes()).hexdigest()[:16]


def compare(name: str, got: torch.Tensor, want: torch.Tensor, **extra):
    dig = DIGESTS[name] = digest(got)
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    rec = {"check": name, "max_abs_err": err, "max_abs_ref": scale,
           "rel_err": err / max(scale, 1e-30), "tol": TOL, "digest": dig,
           **extra}
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
           "digest": digest(got), **extra}
    DIGESTS[name] = rec["digest"]
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
        gc.collect()                # the plain version's f32 weights
        torch.cuda.empty_cache()
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


def check_moe_ffn(layer, cfg, x, flush, tag: str, chunks: int = 1):
    """B9 on ``x``'s capacity buffers (``capacity_buffers``; with
    ``chunks``, the first of that many slices of the capacity dim, as
    ``ep_a2a``'s ``a2a_chunks`` sends them) and the layer's experts scaled
    apart per channel (``varied_experts``), held row by row; timed against
    the plain version and the library's bf16 ``bmm`` -> SwiGLU -> ``bmm``
    (two cuBLAS calls and the elementwise ops between them, not one
    call).  Every expert's weights and every buffer row are read, whatever
    the routing."""
    import torch.nn.functional as F_
    from repro_torch.kernels import moe_ffn
    from repro_torch.kernels.moe_ffn import moe_ffn_plain
    xe, dropped = capacity_buffers(layer, cfg, x)
    if chunks > 1:
        xe = xe[:, : xe.shape[1] // chunks].contiguous()
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
#: the decode shapes of the families (query heads, kv heads, hd, window):
#: qwen3-moe g 16, llama4-scout g 5 and qwen3-32b g 8 at hd 128 (a group
#: split over the grid: 4 x 4, 5 whole, 2 x 4 query heads a block), and
#: h2o-danube g 4 at hd 80 (computed padded to 128) under a window, and
#: zamba2's shared attention, 32 heads of 64 (MHA); B4 and B8 take them
#: over the lens of the OLMoE check, every row held bit for bit alone
#: against the batch
FAMILY_DECODE = {
    "qwen3_moe_g16": (64, 4, 128, None),
    "llama4_g5": (40, 8, 128, None),
    "qwen3_32b_g8": (64, 8, 128, None),
    "danube_g4_hd80_window": (32, 8, 80, 150),
    "zamba2_hd64": (32, 32, 64, None),
}
FAMILY_LENS = [512, 511, 480, 300, 129, 64, 16, 0]


def check_flash_decode_paged(cfg, flush, device):
    """B4 at OLMoE's widths (16 query heads of 128, pages of 16) on each of
    FDP_SHAPES, then at each of FAMILY_DECODE's widths over FAMILY_LENS, a
    64-column table walked through a narrower view, each (row, head) held
    to ROW_TOL; then each row of the check, the GQA shape and every family
    shape alone at its own live-page width against the batch at the full
    64 columns, bit for bit.  No single PyTorch call takes a block table:
    library_ms null."""
    from repro_torch.kernels import flash_decode_paged
    from repro_torch.kernels.flash_decode_paged import \
        flash_decode_paged_plain
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    p, n_blk = 16, 64
    shapes = {tag: (lens, cfg.num_heads, hkv, cfg.head_dim_, window, live)
              for tag, (lens, hkv, window, live) in FDP_SHAPES.items()}
    shapes.update({tag: (FAMILY_LENS, hq, hkv, hd, window, 32) for tag,
                   (hq, hkv, hd, window) in FAMILY_DECODE.items()})
    per = {}
    for tag, (lens, hq, hkv, hd, window, live) in shapes.items():
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
        if tag in ("olmoe_b8", "gqa_window") or tag in FAMILY_DECODE:
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
#: B7 at MiniCPM3-4B's widths (heads, r, dr, the model's qk dims dn + dr
#: for the scale): 40 heads in three tiles of 16 (the last partial), r 256,
#: dr 32, over the DeepSeek check's lens
FDPM_FAMILY = {"minicpm3_h40": (40, 256, 32, 64 + 32)}


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
    p, n_blk = 16, 64
    shapes = {tag: (lens, live, cfg.num_heads, cfg.kv_lora_rank,
                    cfg.qk_rope_head_dim,
                    cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
              for tag, (lens, live) in FDPM_SHAPES.items()}
    shapes.update({tag: (FDPM_SHAPES["deepseek_b8"][0], 32, *v)
                   for tag, v in FDPM_FAMILY.items()})
    per = {}
    for tag, (lens, live, h, r, dr, qk) in shapes.items():
        scale = 1.0 / qk ** 0.5
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
        if tag == "deepseek_b8" or tag in FDPM_FAMILY:
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
    """B2 at OLMoE's widths (16 heads of 128) on the forward's shape and the
    edges of its tiling, then at h2o-danube's (32 query heads, 8 kv heads
    of 80): its forward's strided views under its 4096 window, a window
    inside the sequence, a ragged S; every (row, head) held to ROW_TOL.
    The OLMoE and danube forwards are timed against the plain version and
    SDPA (is_causal; GQA through ``enable_gqa``).  Returns {shape:
    numbers}."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain
    gen = torch.Generator(device=device)
    gen.manual_seed(4)

    def qkv(b, hq, hkv, s, hd, strided):
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
    # strided views of [B, S, H, hd] activations; then danube's hd 80
    hq, hd = cfg.num_heads, cfg.head_dim_
    shapes = {"forward": (4, hq, cfg.num_kv_heads, 512, None, hd, False),
              "prefill_ragged": (1, hq, cfg.num_kv_heads, 200, None, hd,
                                 False),
              "gqa_window": (2, hq, hq // 4, 384, 100, hd, False),
              "hd64_forward": (4, hq, cfg.num_kv_heads, 512, None, 64, False),
              "hd64_s37_gqa_window": (1, hq, hq // 4, 37, 16, 64, False),
              "strided_s200_gqa_window": (2, hq, hq // 4, 200, 100, hd, True),
              "danube_forward_hd80": (4, 32, 8, 512, 4096, 80, True),
              "danube_hd80_window": (2, 32, 8, 384, 100, 80, False),
              "danube_hd80_s37_window": (1, 32, 8, 37, 16, 80, True)}
    errs = {}
    for tag, (b, hq_, hkv, s, window, hd_, strided) in shapes.items():
        args = qkv(b, hq_, hkv, s, hd_, strided)
        got = flash_attention(*args, window=window)
        if got.stride() != args[0].stride():
            raise AssertionError(f"flash_attention_{tag}: output strides "
                                 f"{got.stride()} != q's {args[0].stride()}")
        errs[tag] = compare_rows(f"flash_attention_{tag}", got,
                                 flash_attention_plain(*args, window=window),
                                 shape=[b, hq_, hkv, s, hd_], window=window,
                                 strided=strided)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    per = {}
    for tag, key in (("olmoe_forward", "forward"),
                     ("danube_forward_hd80", "danube_forward_hd80")):
        b, hq_, hkv, s, window, hd_, strided = shapes[key]
        q, k, v = qkv(b, hq_, hkv, s, hd_, strided)
        gqa = {"enable_gqa": True} if hkv != hq_ else {}
        ms, plain_ms, lib_ms = time_calls(
            (lambda: flash_attention(q, k, v, window=window),
             lambda: flash_attention_plain(q, k, v, window=window),
             lambda: sdpa(q, k, v, is_causal=True, **gqa)), flush)
        nbytes = (2 * b * hq_ * s * hd_ + 2 * b * hkv * s * hd_) * 2
        flops = 4 * b * hq_ * hd_ * _causal_pairs(s, window)
        err = max(e for t, e in errs.items()
                  if t.startswith("danube_") == (tag != "olmoe_forward"))
        per[tag] = (err, ms, plain_ms, nbytes, flops, lib_ms)
    return per


def _decode_cache(gen, device, lens, s_buf, hkv, hd, dtype=torch.bfloat16):
    """k, v [B, S_buf, Hkv, hd] and pos [B, S_buf] as the engine leaves
    them: row b holds positions 0..lens[b]-1 at slot pos % S_buf."""
    b = len(lens)
    k, v = (torch.randn((b, s_buf, hkv, hd), generator=gen, device=device,
                        dtype=dtype) for _ in range(2))
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
    then at each of FAMILY_DECODE's widths over FAMILY_LENS on a 512-slot
    cache (danube's on a 200-slot ring under its window: rows longer than
    200 have wrapped), each
    (row, head) held to ROW_TOL; then each row of the check, of the GQA
    shape and of every family shape alone against the same row in the
    batch, bit for bit.  Timed against the plain version and, on the MHA
    and family shapes, the library's attention with a boolean mask built
    from pos (library_ms; GQA through ``enable_gqa``)."""
    from repro_torch.kernels import flash_decode
    from repro_torch.kernels.flash_decode import flash_decode_plain
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = {tag: (lens, s_buf, cfg.num_heads, cfg.num_heads // group,
                    cfg.head_dim_, window)
              for tag, (lens, s_buf, group, window) in FD_SHAPES.items()}
    shapes.update({tag: (FAMILY_LENS, 200 if window else 512, hq, hkv, hd,
                         window)
                   for tag, (hq, hkv, hd, window) in FAMILY_DECODE.items()})
    per = {}
    for tag, (lens, s_buf, hq, hkv, hd, window) in shapes.items():
        b = len(lens)
        q = torch.randn((b, hq, hd), generator=gen, device=device,
                        dtype=torch.bfloat16)
        k, v, pos, cur = _decode_cache(gen, device, lens, s_buf, hkv, hd)
        args = (q, k, v, pos, cur)
        got = flash_decode(*args, window=window)
        err = compare_rows(f"flash_decode_{tag}", got,
                           flash_decode_plain(*args, window=window),
                           batch=b, heads=[hq, hkv], slots=s_buf,
                           window=window, live_positions=sum(lens))
        if tag in ("olmoe_b8", "gqa_window") or tag in FAMILY_DECODE:
            bitwise_rows(
                f"flash_decode_{tag}_rows",
                lambda *a: flash_decode(*a, window=window), lens,
                lambda r, _: tuple(t[r:r + 1] for t in args), got)
        valid = (pos >= 0) & (pos <= cur[:, None])
        if window is not None:
            valid &= pos > cur[:, None] - window
        fns = [lambda: flash_decode(*args, window=window),
               lambda: flash_decode_plain(*args, window=window)]
        if hkv == hq or tag in FAMILY_DECODE:
            qm, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
            mask = valid[:, None, None, :]
            gqa = {"enable_gqa": True} if hkv != hq else {}
            fns.append(lambda: sdpa(qm, kt, vt, attn_mask=mask, **gqa))
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


#: the numbers a row keeps for each of its dtypes or shapes (B1 / B6 f32:
#: also the real rows, the rows the kernel counts and computes, the row
#: tile, and the library call on the real rows alone; B7 f32: its launch)
NESTED_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "sibling_ms", "experts", "bytes", "rows",
               "rows_live_tiles", "rows_computed", "block_m",
               "library_real_rows_ms",
               "library_real_rows_align", "launch")


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
    caches = models.init_caches(cfg, layout="paged", page_size=page_size,
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


#: the full-depth gate: the kernel path's logits may lie at most this many
#: times as far (largest row error) from an f32 witness as the bf16 plain
#: path's.  Both paths keep a bf16 residual stream, which moves them from
#: the exact answer by about the same amount over the layers; the kernels
#: round the softmax weights to bf16 once more a layer.  A wrong kernel
#: moves its rows by their own size, far past twice that
WITNESS_RATIO = 2.0


@contextmanager
def as_f32(params, keep=()):
    """The bf16 weights cast to f32 in place while the block runs, and back
    after (bf16 -> f32 -> bf16 is exact): the witness holds one copy of the
    model on the card, pixtral's 24.5 GB as 49 GB and not 73.5.  The
    tensors of ``keep`` stay as they are."""
    from repro_torch.tree import leaves
    kept = {id(t) for t in keep}
    cast = list({id(t): t for t in leaves(params)
                 if isinstance(t, torch.Tensor) and id(t) not in kept
                 and t.dtype == torch.bfloat16}.values())
    for t in cast:
        t.data = t.data.float()
    try:
        yield
    finally:
        for t in cast:
            t.data = t.data.to(torch.bfloat16)
        torch.cuda.empty_cache()


def witness_gate(check, got_all, plain_all, exact_all, **extra):
    """Print the (prefill, decode) logits' distance (largest row error) of
    the kernel path and of the bf16 plain path from the f32 witness, and
    the kernel path's from the plain path; fail unless every value is
    finite and the kernel path lies within WITNESS_RATIO times the plain
    path's distance."""
    rec = {"check": check, "witness": "f32", "ratio_limit": WITNESS_RATIO}
    ok = True
    for i, step in enumerate(("prefill", "decode")):
        got, plain, exact = got_all[i], plain_all[i], exact_all[i]
        k, pl = (row_rel_err(x, exact).max().item() for x in (got, plain))
        rec.update({f"{step}_kernel_vs_f32": k, f"{step}_plain_vs_f32": pl,
                    f"{step}_kernel_vs_plain":
                        row_rel_err(got, plain).max().item(),
                    f"{step}_finite": bool(torch.isfinite(got).all())})
        ok &= rec[f"{step}_finite"] and k <= WITNESS_RATIO * pl
    rec.update(extra)
    emit(rec)
    if not ok:
        raise AssertionError(f"witness check failed: {rec}")


def depth_gate(check, params, cfg, kernel, plain, layers, guard=True,
               witness=True, **extra):
    """The kernel paths' logits against the plain paths' on the same
    weights.  ``kernel(p, c)`` and ``plain(p, c)`` each return {key:
    (prefill, decode) logits}; the kernel side is counted and, with
    ``guard``, runs with no plain attention and no kernel's plain version
    on the card.  With ``witness``, first at full depth: the plain side
    once more on the weights cast to f32 (``as_f32``, a config of dtype
    float32), each key's kernel rows held to it by ``witness_gate``.
    Then through the model cut to its first ``layers`` layers, each key's
    rows within LOGITS_TOL of the plain side's (``gate_logits``).  Checks
    are named ``{check}_{key}``.  Returns the cut model's kernel-side
    launch counts (all keys')."""
    def kernel_side(p, c):
        if not guard:
            return counted(lambda: kernel(p, c))
        with forbid_sdpa(), forbid_plain():
            return counted(lambda: kernel(p, c))

    def launched(counts):
        return {n: v for n, v in counts.items() if v}
    if witness:
        got, counts = kernel_side(params, cfg)
        want = plain(params, cfg)
        with as_f32(params):
            exact = plain(params, cfg.with_(dtype="float32"))
        for key, lg in got.items():
            witness_gate(f"{check}_{key}_full_depth", lg, want[key],
                         exact[key], layers=cfg.num_layers,
                         launches=launched(counts), **extra)
        del got, want, exact
    cut = cfg.with_(num_layers=layers)
    p_cut = dict(params, layers=params["layers"][:layers])
    got, counts = kernel_side(p_cut, cut)
    want = plain(p_cut, cut)
    for key, lg in got.items():
        gate_logits(f"{check}_{key}", lg, want[key], layers=layers,
                    launches=launched(counts), **extra)
    return counts


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
    ``eng`` serves (wraps the instance's ``_sample`` and ``_first_token``,
    and its runner's ``whole_prefill``, whose [1, V] logits a whole
    prompt's first token is sampled from; the engine itself has no
    hook)."""
    rows, last = {}, {}
    sample, first = eng._sample, eng._first_token
    whole = eng.runner.whole_prefill

    def sampling(logits):
        last["logits"] = logits
        return sample(logits)

    def whole_prefill(*a, **kw):
        out = whole(*a, **kw)
        last["whole"] = out[0]
        return out

    def first_token(t, tok):
        lg = last.pop("whole", None)
        row = lg[0] if lg is not None else last["logits"][t.slot]
        rows[t.req.uid] = row.float().clone()
        first(t, tok)
    eng._sample, eng._first_token = sampling, first_token
    eng.runner.whole_prefill = whole_prefill
    try:
        yield rows
    finally:
        del eng._sample, eng._first_token, eng.runner.whole_prefill


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
    Returns ({step: (counts, kernels the step must launch)}, the graphed
    baseline's first-token logits rows by uid)."""
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
            with first_token_rows(eng) as first:
                res, counts = counted(
                    lambda: eng.serve(requests(cfg, seed=0), plan=plan_name))
            if tag == "baseline":
                rows = first
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
    return need, rows


# --------------------------------------------------------------------------- #
# phase 7b: the reference kernels' float32 contract (C12)
# --------------------------------------------------------------------------- #

#: an f32 kernel against its plain version, elementwise: |kernel - plain|
#: <= F32_TOL |plain| + F32_TOL max(1, the row's largest |plain|), the
#: reference's own f32 tolerance for its kernels (rtol = atol = 2e-5,
#: tests/test_kernels.py) with atol in units of the row (one token's
#: outputs, one head's hd values) where that row is larger than 1.  The
#: reference's cases are O(1); OLMoE's init (w1's std 1/sqrt(E) = 1/8)
#: makes full-width expert outputs O(100), where two f32 summation orders
#: over D 2048 differ by about 1e-4 at an element near zero (the bits of
#: cuBLAS's sequential sum are B1's; its split sum at C 4 differed from
#: B9's by 1.2e-4 at a row of 82).  ``f64_witness`` shows that this is
#: summation order, not a fault: there B9 lies 1.17e-4 from the f64
#: value (72.4) and the split sum 5.5e-6, both far inside the f32
#: summation bound of that element (2.31; the kernel takes at most 5.2e-5
#: of the bound anywhere in the output): B9 sums each output's K in one
#: sequential chain.  bf16 rounding anywhere (2^-9 a value) or TF32
#: (2^-12) moves a row by 30x or 8x this bound
F32_TOL = 2e-5
#: the full-width f32 serves: the kernel path's first-token logits rows
#: within F32_LOGITS_TOL (each row's relative L2 error) of the plain f32
#: path's, and at most F32_RATIO times as far from them as the bf16 kernel
#: path's rows are (no bf16 or TF32 rounding hides in an f32 kernel)
F32_LOGITS_TOL = 1e-3
F32_RATIO = 0.1
#: the trained-tiny recipe (``launch/serve_lexi.py``) through the kernels:
#: Alg. 1's table and the held-out ppl within this relative distance of
#: the plain paths'
RECIPE_TOL = 1e-4
#: the decode rows of the f32 attention checks (lens) at full width and
#: at the reduced config's, and the reduced config's prompt rows
F32_LENS = [512, 511, 480, 300, 129, 64, 16, 0]
F32_REDUCED_LENS = [96, 50, 17, 7, 1, 0]


def compare_f32(name: str, got: torch.Tensor, want: torch.Tensor, **extra):
    """Hold an f32 kernel's output to its plain version's elementwise at
    F32_TOL (the line also carries the ratio at an atol of 2e-5 itself,
    ``max_err_over_unit_atol``); returns the largest absolute
    difference."""
    if got.dtype != torch.float32 or want.dtype != torch.float32:
        raise AssertionError(f"{name}: outputs {got.dtype} / {want.dtype}, "
                             "want float32")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    row = want.abs().amax(-1, keepdim=True).clamp(min=1.0)
    bound = F32_TOL * want.abs() + F32_TOL * row
    rec = {"check": name, "max_abs_err": err.max().item(),
           "max_abs_ref": want.abs().max().item(),
           "max_err_over_tol": (err / bound).max().item(), "tol": F32_TOL,
           "max_err_over_unit_atol": (err / (F32_TOL + F32_TOL * want.abs()))
           .max().item(), "digest": digest(got), **extra}
    DIGESTS[name] = rec["digest"]
    emit(rec)
    if rec["max_err_over_tol"] > 1.0:
        raise AssertionError(f"{name}: |kernel - plain| past {F32_TOL} "
                             f"(|plain| + the row's scale) ({rec})")
    return rec["max_abs_err"]


def meta_cost_equal(name, wrapper, args, kw):
    """The kernel's launch on the card reports the cost its ``meta`` route
    reports for the same arguments (the dry run's count, f32 included)."""
    from repro_torch.analysis.counters import count
    with count() as card:
        wrapper(*args, **kw)
    meta_args = [a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args]
    with count() as dry:
        wrapper(*meta_args, **kw)
    got = (card.kernel_calls, card.kernel_flops, card.kernel_bytes)
    want = (dry.kernel_calls, dry.kernel_flops, dry.kernel_bytes)
    if got != want or got[0] != {name: 1}:
        raise AssertionError(f"{name} f32: the card reports {got}, meta "
                             f"{want}")


def f32_case(name, tag, wrapper, plain, args, kw, sibling, library, nbytes,
             flops, flush, rows=None, **extra):
    """One f32 shape of a kernel: held to its plain version (compare_f32),
    its cost equal on the card and on meta, then timed with the plain
    version, the bf16 kernel on the same inputs rounded to bf16 beforehand
    (``sibling``: a thunk, or None where the shape has no bf16 instance)
    and the library call (a thunk, or None).  ``rows`` (B1 / B6): the
    sorted buffer's row numbers (``gmm_rows``), kept in the numbers and on
    the check line, and its ``library_real_rows`` thunk timed in the same
    turns.  Returns the numbers ``kernel_row`` takes, f32 rates."""
    rows = dict(rows or {})
    real = rows.pop("library_real_rows", None)
    err = compare_f32(f"{name}_f32_{tag}", wrapper(*args, **kw),
                      plain(*args), **rows, **extra)
    meta_cost_equal(name, wrapper, args, kw)
    fns = [lambda: wrapper(*args, **kw), lambda: plain(*args)]
    fns += [f for f in (sibling, library, real) if f is not None]
    ms, plain_ms, *more = time_calls(fns, flush)
    sib_ms = more.pop(0) if sibling is not None else None
    lib_ms = more.pop(0) if library is not None else None
    if real is not None:
        rows["library_real_rows_ms"] = more.pop(0)
    return (err, ms, plain_ms, nbytes, flops, lib_ms,
            {"sibling_ms": sib_ms, **rows})


def gmm_rows(xs, plan, x, idx, w1=None, w2=None):
    """B1 / B6 f32 on a sorted buffer ``xs``: the real rows (token copies),
    the rows of its live tiles (what the contract's tiles hold), the rows
    the kernels count and compute (``tile_rows``: each tile's up to its
    last nonzero row), the row tile; with f32 ``w1`` / ``w2`` (B1)
    also ``library_real_rows``, a thunk of B1's function on the real rows
    alone (``torch._grouped_mm``, SwiGLU, ``torch._grouped_mm``, offsets
    from the plan's group sizes): where the card's torch refuses unaligned
    offsets, each group rounded up to 16 rows (``library_real_rows_align``
    says which)."""
    import torch.nn.functional as F_
    from repro_torch.kernels.moe_gmm import tile_rows
    from repro_torch.models.moe import make_sort_plan, sort_dispatch
    k = idx.shape[1]
    out = {"rows": x.shape[0] * k, "block_m": plan.block_m,
           "rows_live_tiles": int(plan.tile_valid.sum()) * plan.block_m,
           "rows_computed": int(tile_rows(xs, plan.tile_valid,
                                          plan.block_m).sum())}
    if w1 is None:
        return out
    e, f = w1.shape[0], w2.shape[1]
    errors = []
    for align in (1, 16):
        p = make_sort_plan(idx, e, align)
        offs = torch.cumsum(p.padded_group_sizes, 0).to(torch.int32)
        xr = sort_dispatch(x, p, k)[:int(offs[-1])]

        def real(xr=xr, offs=offs):
            h = torch._grouped_mm(xr, w1, offs=offs)
            return torch._grouped_mm(F_.silu(h[:, :f]) * h[:, f:], w2,
                                     offs=offs)
        try:
            real()
        except (AttributeError, RuntimeError, ValueError) as err:
            errors.append(f"{type(err).__name__}: {err}"[:200])
            continue
        out.update(library_real_rows=real, library_real_rows_align=align)
        return out
    emit({"check": "moe_gmm_f32_grouped_mm_real_rows", "error": errors})
    return out


def to_bf16(*ts):
    """The float tensors of ``ts`` rounded to bf16: a bf16 sibling's
    inputs."""
    return [t.to(torch.bfloat16) if t.is_floating_point() else t
            for t in ts]


def f32_expert_checks(layer, cfg, x, flush, tag, per, witness=False,
                      x_fwd=None):
    """B1, B3 and B9 in f32 on ``layer`` (f32 weights) and f32 tokens
    ``x``: B1 on the sorted dispatch at top-k of ``x`` and of its first
    F32_CHUNK tokens (``f32_gmm_case``), B3 on its first 8 tokens
    at top-k, B9 on the capacity buffers of its first 8 tokens and of all
    of them (and of ``x_fwd``'s, the forward's, where given), each B9
    buffer's rows also alone against the batch, bit for bit
    (``ffn_rows_alone``); the sibling is the bf16 kernel on the same inputs
    rounded to bf16.  ``witness``: B9 on the first 8 tokens' buffers and
    on all of ``x``'s also against f64 (``f64_witness``).  Adds {kernel:
    {f32 shape: numbers}} to ``per``."""
    import torch.nn.functional as F_
    from repro_torch.kernels import moe_decode, moe_ffn
    from repro_torch.kernels.moe_decode import moe_decode_plain
    from repro_torch.kernels.moe_ffn import moe_ffn_plain
    from repro_torch.models.moe import route
    k, e = cfg.moe_top_k, cfg.num_experts
    d, f = cfg.d_model, cfg.moe_d_ff
    w1, w2 = layer["w1"], layer["w2"]
    b1, b2 = to_bf16(w1, w2)
    f32_gmm_case(layer, cfg, x, flush, tag, per, b1, b2)
    f32_gmm_case(layer, cfg, x[:F32_CHUNK], flush, f"{tag}_t{F32_CHUNK}",
                 per, b1, b2)

    x8 = x[:8].contiguous()
    weights, idx8, _ = route(layer, cfg, x8, k)
    x8_b = to_bf16(x8)[0]
    dec_args = (x8, w1, w2, idx8, weights)
    experts = int(torch.unique(idx8).numel())
    per.setdefault("moe_decode", {})[f"f32_{tag}_k{k}"] = f32_case(
        "moe_decode", f"{tag}_k{k}", moe_decode, moe_decode_plain, dec_args,
        {}, lambda: moe_decode(x8_b, b1, b2, idx8, weights), None,
        experts * 3 * d * f * 4 + 2 * 8 * d * 4 + 8 * k * 8,
        8 * k * 6 * d * f, flush, batch=8, k=k, experts=experts)

    shapes = [("c_decode", x8), ("c_chunk", x)]
    if x_fwd is not None:
        shapes.append(("c_forward", x_fwd))
    for sh, xx in shapes:
        xe, dropped = capacity_buffers(layer, cfg, xx)
        xe_b = to_bf16(xe)[0]
        c = xe.shape[1]
        got = moe_ffn(xe, w1, w2)
        if witness and sh != "c_forward":
            f64_witness(f"moe_ffn_f32_{tag}_{sh}{c}_f64", xe, w1, w2, got,
                        moe_ffn_plain(xe, w1, w2))
        if sh != "c_forward":
            ffn_rows_alone(f"moe_ffn_f32_{tag}_{sh}{c}_rows", xe, w1, w2,
                           got)
        del got

        def bmm_swiglu(xe=xe):
            h = torch.bmm(xe, w1)
            return torch.bmm(F_.silu(h[..., :f]) * h[..., f:], w2)
        per.setdefault("moe_ffn", {})[f"f32_{tag}_{sh}{c}"] = f32_case(
            "moe_ffn", f"{tag}_{sh}{c}", moe_ffn, moe_ffn_plain,
            (xe, w1, w2), {}, lambda xe_b=xe_b: moe_ffn(xe_b, b1, b2),
            bmm_swiglu, e * 3 * d * f * 4 + 2 * e * c * d * 4,
            e * c * 6 * d * f, flush, capacity=c, dropped_copies=dropped)


def f32_gmm_case(layer, cfg, x, flush, tag, per, b1, b2):
    """B1 in f32 on ``x``'s sorted dispatch at top-k: held to its plain
    version, timed with the bf16 kernel on the inputs rounded to bf16
    (``b1``, ``b2``: the experts in bf16) and ``torch._grouped_mm``, SwiGLU,
    ``torch._grouped_mm`` on the rows of the plan's valid tiles (padding
    included, as B1's contract has them) and on the real rows alone
    (``gmm_rows``); adds ``per["moe_gmm"]["f32_<tag>"]``."""
    import torch.nn.functional as F_
    from repro_torch.kernels import moe_gmm
    from repro_torch.kernels.moe_gmm import moe_gmm_plain
    from repro_torch.models.moe import default_block_m, make_sort_plan, \
        route, sort_dispatch
    k, e = cfg.moe_top_k, cfg.num_experts
    d, f = cfg.d_model, cfg.moe_d_ff
    w1, w2 = layer["w1"], layer["w2"]
    _, idx, _ = route(layer, cfg, x, k)
    plan = make_sort_plan(idx, e, default_block_m(x.shape[0] * k, floor=8))
    xs = sort_dispatch(x, plan, k)
    xs_b = to_bf16(xs)[0]
    bm = plan.block_m
    gmm_args = (xs, w1, w2, plan.tile_expert, plan.tile_valid)
    live_e = plan.tile_expert[plan.tile_valid.bool()].long()
    experts = int(torch.unique(live_e).numel())
    offs = torch.cumsum(torch.bincount(live_e, minlength=e) * bm,
                        0).to(torch.int32)
    live = int(offs[-1])

    def grouped_mm():
        h = torch._grouped_mm(xs[:live], w1, offs=offs)
        return torch._grouped_mm(F_.silu(h[:, :f]) * h[:, f:], w2, offs=offs)
    try:                                  # the card's torch may refuse f32
        grouped_mm()
        library = grouped_mm
    except (AttributeError, RuntimeError, ValueError) as err:
        library = None
        emit({"check": f"moe_gmm_f32_{tag}_grouped_mm",
              "error": f"{type(err).__name__}: {err}"[:300]})
    rows = x.shape[0] * k
    per.setdefault("moe_gmm", {})[f"f32_{tag}"] = f32_case(
        "moe_gmm", tag, lambda *a, **kw: moe_gmm(*a, **kw),
        lambda *a: moe_gmm_plain(*a, bm), gmm_args, {"block_m": bm},
        lambda: moe_gmm(xs_b, b1, b2, plan.tile_expert, plan.tile_valid,
                        block_m=bm),
        library, 2 * rows * d * 4 + experts * 3 * d * f * 4
        + 2 * 4 * len(plan.tile_valid), rows * 6 * d * f, flush,
        rows=gmm_rows(xs, plan, x, idx, w1, w2), tokens=x.shape[0], k=k,
        experts=experts)


#: B1 / B6 f32 also on the first F32_CHUNK tokens of each check (a serve
#: chunk's prefill)
F32_CHUNK = 64

#: B9 f32's capacities at F32_QUANT_WIDE's D 5120 and F 8192: its decode
#: body stages a row group's rows in chunks there (C 4, 8, 24), its tile
#: body takes C 25
F32_WIDE_CAPACITIES = (4, 8, 24, 25)


def f32_ffn_wide(layer, x, tag):
    """B9 in f32 on ``layer``'s experts and capacity buffers filled from
    ``x``'s rows (the second half of each buffer empty) at
    F32_WIDE_CAPACITIES, held to its plain version (compare_f32) and its
    empty rows to exactly 0; not timed."""
    from repro_torch.kernels import moe_ffn
    from repro_torch.kernels.moe_ffn import moe_ffn_plain
    w1, w2 = layer["w1"], layer["w2"]
    e, d = w1.shape[0], w1.shape[1]
    for c in F32_WIDE_CAPACITIES:
        xe = x[: e * c].reshape(e, c, d).clone()
        xe[:, (c + 1) // 2:] = 0
        got = moe_ffn(xe, w1, w2)
        compare_f32(f"moe_ffn_f32_{tag}_wide_c{c}", got,
                    moe_ffn_plain(xe, w1, w2), capacity=c, d=d,
                    f=w2.shape[1])
        if (got[:, (c + 1) // 2:] != 0).any():
            raise AssertionError(f"moe_ffn_f32_{tag}_wide_c{c}: an empty "
                                 "capacity row is not 0")
        del got


def ffn_rows_alone(name, xe, w1, w2, batch_out):
    """B9: each capacity row c alone in its buffer (every other row of
    every expert's buffer zero) gives the bits it gives in ``batch_out``,
    and a row that is zero in ``xe`` (no token copy filled it) comes out
    exactly 0."""
    from repro_torch.kernels import moe_ffn
    empty = xe.abs().amax(-1) == 0                        # [E, C]
    if (batch_out[empty] != 0).any():
        raise AssertionError(f"{name}: an empty capacity row is not 0")
    alone = torch.zeros_like(xe)
    for c in range(xe.shape[1]):
        alone[:, c] = xe[:, c]
        if not torch.equal(moe_ffn(alone, w1, w2)[:, c], batch_out[:, c]):
            raise AssertionError(f"{name}: row {c} alone differs from the "
                                 "same row in the buffer")
        alone[:, c] = 0
    emit({"check": name, "bitwise_rows": xe.shape[1],
          "empty_rows": int(empty.sum()), "ok": True})


#: Higham's unit roundoff of f32 (round to nearest)
F32_U = 2.0 ** -24


def f64_witness(check, xe, w1, w2, got, plain):
    """C13: B9's f32 output ``got`` and its plain version's ``plain``
    (cuBLAS's f32 ``bmm`` pair) against the same SwiGLU computed in f64,
    beside the rounding-error bound of any f32 evaluation of it, element
    by element (gamma_n = n u / (1 - n u), u = 2^-24): the down product's
    gamma_F sum_f |h_f| |w2_fd|, plus the gate and up products' gamma_D
    sum_i |x_i| |w1_if| carried through the SwiGLU's derivatives and 4u
    |h_f| for its own roundings, summed against |w2_fd| (first order).
    Prints the three numbers at the element where the kernel and the plain
    version differ most, and the largest share of the bound each takes
    over the output; fails if the kernel leaves the bound anywhere (a
    fault, not an order of summation)."""
    f, d = w2.shape[1], xe.shape[-1]
    x, a1, a2 = xe.double(), w1.double(), w2.double()
    hg = torch.bmm(x, a1)
    g, up = hg[..., :f], hg[..., f:]
    sig = torch.sigmoid(g)
    silu = g * sig
    h = silu * up
    want = torch.bmm(h, a2)

    def gamma(n):
        return n * F32_U / (1 - n * F32_U)
    dg = gamma(d) * torch.bmm(x.abs(), a1.abs())
    dh = ((sig * (1 + g * (1 - sig))).abs() * up.abs() * dg[..., :f]
          + silu.abs() * dg[..., f:] + 4 * F32_U * h.abs())
    a2 = a2.abs()
    bound = gamma(f) * torch.bmm(h.abs(), a2) + torch.bmm(dh, a2)
    del hg, g, up, sig, silu, h, dg, dh, a1, a2
    ek = (got.double() - want).abs()
    ep = (plain.double() - want).abs()

    def share(e):           # an empty capacity row: bound and error 0
        return torch.where(bound > 0, e / bound.clamp(min=1e-300),
                           torch.where(e > 0, float("inf"), 0.0))
    at = np.unravel_index(int((got - plain).abs().argmax()), got.shape)
    rec = {"check": check, "witness": "f64", "element": list(map(int, at)),
           "kernel_vs_f64": ek[at].item(), "plain_vs_f64": ep[at].item(),
           "kernel_vs_plain": (got - plain).abs()[at].item(),
           "bound": bound[at].item(), "value": want[at].item(),
           "kernel_max_share_of_bound": share(ek).max().item(),
           "plain_max_share_of_bound": share(ep).max().item(),
           "kernel_max_vs_f64": ek.max().item(),
           "plain_max_vs_f64": ep.max().item()}
    emit(rec)
    if not rec["kernel_max_share_of_bound"] <= 1.0:
        raise AssertionError(f"{check}: the kernel lies outside the f32 "
                             f"summation bound ({rec})")


#: B5 and B6 in f32 at llama4-scout-17b-a16e's F 8192 (its first MoE
#: layer, D 5120, 16 experts, top-1)
F32_QUANT_WIDE = "llama4-scout-17b-a16e"


def f32_quant_checks(layer, cfg, x, flush, tag, per):
    """B6 and B5 in f32, int8 and int4, on ``layer``'s experts scaled apart
    (``varied_experts``) and quantized on the card, and f32 tokens ``x``:
    B6 on the sorted dispatch at top-k of ``x`` and of its first F32_CHUNK
    tokens (``gmm_rows``' numbers kept), B5 on its first 8 tokens at
    top-k (one router weight set to zero); the sibling is the bf16
    activations' kernel on the same routing and the same int8 weights,
    ``x`` rounded to bf16.  Adds {kernel: {f32 shape: numbers}} to
    ``per``."""
    from repro_torch.kernels import moe_decode_quant, moe_gmm_quant
    from repro_torch.kernels.moe_decode import moe_decode_quant_plain
    from repro_torch.kernels.moe_gmm import moe_gmm_quant_plain
    from repro_torch.models.moe import QUANT_DTYPES, default_block_m, \
        make_sort_plan, quantize_moe_layer, route, sort_dispatch
    k, d, f = cfg.moe_top_k, cfg.d_model, cfg.moe_d_ff
    varied = varied_experts(layer)
    dispatches = []                 # (tag, x, sorted buffer, plan, numbers)
    for sh, xx in ((tag, x), (f"{tag}_t{F32_CHUNK}", x[:F32_CHUNK])):
        _, idx, _ = route(layer, cfg, xx, k)
        plan = make_sort_plan(idx, cfg.num_experts,
                              default_block_m(xx.shape[0] * k, floor=8))
        xs = sort_dispatch(xx, plan, k)
        dispatches.append((sh, xx, xs, plan, gmm_rows(xs, plan, xx, idx)))
    x8 = x[:8].contiguous()
    weights, idx8, _ = route(layer, cfg, x8, k)
    weights = weights.clone()
    weights[0, -1] = 0.0
    x8_b = to_bf16(x8)[0]
    experts8 = int(torch.unique(idx8).numel())
    for dt in QUANT_DTYPES:
        q = quantize_moe_layer(varied, dt)
        qw = (q["w1"], q["w2"], q["w1_scale"], q["w2_scale"])
        for sh, xx, xs, plan, nums in dispatches:
            bm, te, tv = plan.block_m, plan.tile_expert, plan.tile_valid
            experts = int(torch.unique(te[tv.bool()]).numel())
            rows = xx.shape[0] * k
            xs_b = to_bf16(xs)[0]
            per.setdefault("moe_gmm_quant", {})[f"f32_{sh}_{dt}"] = f32_case(
                "moe_gmm_quant", f"{sh}_{dt}", moe_gmm_quant,
                lambda *a, bm=bm: moe_gmm_quant_plain(*a, bm, dtype=dt),
                (xs, *qw, te, tv), {"dtype": dt, "block_m": bm},
                lambda xs_b=xs_b, bm=bm, te=te, tv=tv: moe_gmm_quant(
                    xs_b, *qw, te, tv, dtype=dt, block_m=bm),
                None, 2 * rows * d * 4 + _quant_bytes(experts, d, f, dt)
                + 2 * 4 * len(tv), rows * 6 * d * f, flush, rows=nums,
                tokens=xx.shape[0], k=k, experts=experts)
        per.setdefault("moe_decode_quant", {})[f"f32_{tag}_{dt}"] = f32_case(
            "moe_decode_quant", f"{tag}_{dt}", moe_decode_quant,
            lambda *a: moe_decode_quant_plain(*a, dtype=dt),
            (x8, *qw, idx8, weights), {"dtype": dt},
            lambda: moe_decode_quant(x8_b, *qw, idx8, weights, dtype=dt),
            None, _quant_bytes(experts8, d, f, dt) + 2 * 8 * d * 4
            + 8 * k * 8, 8 * k * 6 * d * f, flush, batch=8, k=k,
            experts=experts8)
        del q, qw
        gc.collect()                # the plain versions' f32 weights
        torch.cuda.empty_cache()


#: B7 in f32 (heads, r, dr, the model's qk dims dn + dr for the scale):
#: the reduced DeepSeek config's, DeepSeek-V2-Lite's and MiniCPM3-4B's
F32_MLA_SHAPES = {"reduced": (4, 32, 16, 16 + 16),
                  "deepseek": (16, 512, 64, 128 + 64),
                  "minicpm3_h40": (40, 256, 32, 64 + 32)}


def f32_mla_inputs(device):
    """Yield B7's f32 inputs at each of F32_MLA_SHAPES, in order: (tag,
    heads, r, dr, scale, (q_lat, q_rope, ckvp, kropep, posp, table at 64
    columns, cur_pos)) for the 8 rows of F32_LENS on pages of 16 (one
    generator, seed 14, drawn as the checks always drew it)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(14)
    p, n_blk = 16, 64
    lens = F32_LENS
    b = len(lens)
    for tag, (h, r, dr, qk) in F32_MLA_SHAPES.items():
        n = b * 32 + 1
        ckvp, kropep = (torch.randn((n, p, w), generator=gen, device=device)
                        for w in (r, dr))
        q_lat, q_rope = (torch.randn((b, h, w), generator=gen, device=device)
                         for w in (r, dr))
        posp, table, cur = paged_positions(lens, n, p, n_blk, device)
        yield tag, h, r, dr, 1.0 / qk ** 0.5, (q_lat, q_rope, ckvp, kropep,
                                               posp, table, cur)


#: check (a) of the f32 head tiles, by F32_MLA_SHAPES tag: (first head,
#: heads) of the whole call held bit for bit against a call on those heads
#: alone (DeepSeek's first 8 of 16; MiniCPM3's heads 16-31 of 40)
F32_MLA_HEAD_SLICES = {"deepseek": (0, 8), "minicpm3_h40": (16, 16)}


def f32_mla_head_slice(tag, args, scale, got, h0, nh):
    """Heads [h0, h0 + nh) of ``got`` (the whole call on ``args``) must be
    the bits of a call on those heads alone: a head's output depends
    neither on its head tile nor on the other heads.  Emits the check
    line with the slice's digest."""
    from repro_torch.kernels import flash_decode_paged_mla
    name = f"flash_decode_paged_mla_f32_{tag}_heads_{h0}_{h0 + nh}"
    q_lat, q_rope, *rest = args
    alone = flash_decode_paged_mla(
        q_lat[:, h0:h0 + nh].contiguous(), q_rope[:, h0:h0 + nh].contiguous(),
        *rest, scale=scale)
    if not torch.equal(alone, got[:, h0:h0 + nh]):
        raise AssertionError(f"{name}: heads alone differ from the same "
                             "heads of the whole call")
    dig = DIGESTS[name] = digest(alone)
    emit({"check": name, "bitwise_heads": [h0, h0 + nh], "ok": True,
          "digest": dig})


def f32_mla_checks(flush, device, per):
    """B7 on f32 latent pools at each of F32_MLA_SHAPES
    (``f32_mla_inputs``): the 8 rows of F32_LENS (up to 512 positions, one
    idle) on pages of 16, a 64-column table walked through a 32-column
    view, each row also alone at its own live width against the batch at
    64 columns, bit for bit, and at F32_MLA_HEAD_SLICES a slice of heads
    alone against the whole call, bit for bit; the sibling is the bf16
    kernel on the latents rounded to bf16 (none at (32, 16), which only
    f32 latents take).  The line and the numbers carry the f32 instance's
    launch (``mla_f32_launch_shape``: head tile, blocks, stages, shared
    memory).  Adds {kernel: {f32 shape:
    numbers}} to ``per``."""
    from repro_torch.kernels import flash_decode_paged_mla
    from repro_torch.kernels.flash_decode_paged import MLA_SHAPES, \
        flash_decode_paged_mla_plain, mla_f32_launch_shape
    p, live = 16, 32
    lens = F32_LENS
    b = len(lens)
    for tag, h, r, dr, scale, full in f32_mla_inputs(device):
        q_lat, q_rope, ckvp, kropep, posp, table, cur = full
        args = (q_lat, q_rope, ckvp, kropep, posp, table[:, :live], cur)
        lat_b = to_bf16(ckvp, kropep)
        sibling = None
        if (r, dr) in MLA_SHAPES[torch.bfloat16]:
            def sibling():
                return flash_decode_paged_mla(q_lat, q_rope, *lat_b, posp,
                                              table[:, :live], cur,
                                              scale=scale)
        pages, slots = live_work(posp, table[:, :live], cur)
        launch = (mla_f32_launch_shape(b, h, r, dr, live)
                  if torch.device(device).type == "cuda" else None)
        per.setdefault("flash_decode_paged_mla", {})[f"f32_{tag}"] = f32_case(
            "flash_decode_paged_mla", tag, flash_decode_paged_mla,
            lambda *a: flash_decode_paged_mla_plain(*a, scale=scale), args,
            {"scale": scale}, sibling, None,
            pages * p * (r + dr) * 4 + pages * p * 4 + b * h * (r + dr) * 4
            + b * h * r * 4 + b * live * 4 + b * 4,
            slots * h * (2 * (r + dr) + 2 * r), flush,
            rows={"launch": launch}, batch=b, heads=h, latent=[r, dr],
            live_positions=sum(lens), table_cols=live)
        whole = flash_decode_paged_mla(q_lat, q_rope, ckvp, kropep, posp,
                                       table, cur, scale=scale)
        bitwise_rows(
            f"flash_decode_paged_mla_f32_{tag}_rows",
            lambda *a: flash_decode_paged_mla(*a, scale=scale), lens,
            lambda i, w: (q_lat[i:i + 1], q_rope[i:i + 1], ckvp, kropep,
                          posp, table[i:i + 1, :w], cur[i:i + 1]), whole)
        if tag in F32_MLA_HEAD_SLICES:
            f32_mla_head_slice(tag, full, scale, whole,
                               *F32_MLA_HEAD_SLICES[tag])


def f32_attention_checks(hq, hkv, hd, lens, s_buf, seq, window, device,
                         flush, tag, per):
    """B2, B8 and B4 in f32 at (hq, hkv, hd): B2 on 4 rows of ``seq``
    tokens as the model's strided [B, S, H, hd] views (under ``window``),
    B8 on a cache of ``s_buf`` slots and B4 on pages of 16 holding
    ``lens`` positions a row (each row of all three also alone against
    the batch, bit for bit); the sibling is the bf16 kernel on the same
    inputs rounded to bf16, the library SDPA in f32.  Adds {kernel: {f32
    shape: numbers}} to ``per``."""
    from repro_torch.kernels import flash_attention, flash_decode, \
        flash_decode_paged
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_decode import flash_decode_plain
    from repro_torch.kernels.flash_decode_paged import \
        flash_decode_paged_plain
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    gqa = {"enable_gqa": True} if hkv != hq else {}
    b = 4
    q, k, v = (torch.randn((b, seq, h, hd), generator=gen, device=device)
               .transpose(1, 2) for h in (hq, hkv, hkv))
    qkv_b = to_bf16(q, k, v)
    got = flash_attention(q, k, v, window=window)
    if got.is_cuda and got.stride() != q.stride():
        raise AssertionError(f"flash_attention f32 {tag}: output strides "
                             f"{got.stride()} != q's {q.stride()}")
    for r in range(b):                  # a batch row alone, bit for bit
        alone = flash_attention(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                window=window)
        if not torch.equal(alone[0], got[r]):
            raise AssertionError(f"flash_attention f32 {tag}: batch row {r} "
                                 "alone differs from the same row in the "
                                 "batch")
    emit({"check": f"flash_attention_f32_{tag}_rows", "bitwise_rows": b,
          "ok": True})
    per.setdefault("flash_attention", {})[f"f32_{tag}"] = f32_case(
        "flash_attention", tag, flash_attention,
        lambda *a: flash_attention_plain(*a, window=window), (q, k, v),
        {"window": window},
        lambda: flash_attention(*qkv_b, window=window),
        None if window else (lambda: sdpa(q, k, v, is_causal=True, **gqa)),
        (2 * b * hq * seq * hd + 2 * b * hkv * seq * hd) * 4,
        4 * b * hq * hd * _causal_pairs(seq, window), flush,
        shape=[b, hq, hkv, seq, hd], window=window)

    nb = len(lens)
    qd = torch.randn((nb, hq, hd), generator=gen, device=device)
    kc, vc, pos, cur = _decode_cache(gen, device, lens, s_buf, hkv, hd,
                                     dtype=torch.float32)
    args = (qd, kc, vc, pos, cur)
    dec_b = to_bf16(*args)
    valid = (pos >= 0) & (pos <= cur[:, None])
    if window is not None:
        valid &= pos > cur[:, None] - window
    live = int(valid.sum())
    mask = valid[:, None, None, :]
    per.setdefault("flash_decode", {})[f"f32_{tag}"] = f32_case(
        "flash_decode", tag, flash_decode,
        lambda *a: flash_decode_plain(*a, window=window), args,
        {"window": window},
        lambda: flash_decode(*dec_b, window=window),
        lambda: sdpa(qd[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                     attn_mask=mask, **gqa),
        live * hkv * hd * 4 * 2 + live * 4 + 2 * nb * hq * hd * 4 + nb * 4,
        4 * live * hq * hd, flush, batch=nb, slots=s_buf,
        live_positions=sum(lens))
    bitwise_rows(f"flash_decode_f32_{tag}_rows",
                 lambda *a: flash_decode(*a, window=window), lens,
                 lambda r, _: tuple(t[r:r + 1] for t in args),
                 flash_decode(*args, window=window))

    p, n_blk = 16, 64
    n = nb * 32 + 1
    kp, vp = (torch.randn((n, p, hkv, hd), generator=gen, device=device)
              for _ in range(2))
    posp, table, curp = paged_positions(lens, n, p, n_blk, device)
    view = table[:, :32]
    args = (qd, kp, vp, posp, view, curp)
    pg_b = to_bf16(*args)
    pages, slots = live_work(posp, view, curp, window)
    per.setdefault("flash_decode_paged", {})[f"f32_{tag}"] = f32_case(
        "flash_decode_paged", tag, flash_decode_paged,
        lambda *a: flash_decode_paged_plain(*a, window=window), args,
        {"window": window},
        lambda: flash_decode_paged(*pg_b, window=window), None,
        pages * p * hkv * hd * 4 * 2 + pages * p * 4 + 2 * nb * hq * hd * 4
        + nb * 32 * 4, 4 * slots * hq * hd, flush, batch=nb,
        live_positions=sum(lens), table_cols=32)
    bitwise_rows(f"flash_decode_paged_f32_{tag}_rows",
                 lambda *a: flash_decode_paged(*a, window=window), lens,
                 lambda r, w: (qd[r:r + 1], kp, vp, posp, table[r:r + 1, :w],
                               curp[r:r + 1]),
                 flash_decode_paged(qd, kp, vp, posp, table, curp,
                                    window=window))


def f32_kernel_checks(layer, cfg, x, device, flush, x_fwd=None):
    """Each f32 kernel at the reduced OLMoE config's shapes (d 128, 4
    heads of 32, 8 experts at top-2, F 64: its own first MoE layer, 128
    tokens) and at full-width OLMoE's (``layer`` cast to f32, ``x``'s 512
    tokens; B1 and B6 also on its first F32_CHUNK; B9 at C 4 and C 80
    also against f64, ``f64_witness``, and at the forward's C 320 on
    ``x_fwd``'s 2048 tokens), B7 on f32
    latents at F32_MLA_SHAPES, B5, B6 and B9 also at llama4-scout's F 8192
    (F32_QUANT_WIDE; B9 at F32_WIDE_CAPACITIES, ``f32_ffn_wide``), each held to F32_TOL, its cost on the card equal to
    meta's, timed; and B2's bf16 body at hd 32 (the reduced config's
    attention) against its plain version row by row to ROW_TOL.  Returns
    {kernel: {f32 shape: numbers}} for the ``kernels`` line."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain
    per = {}
    rcfg = get_config("olmoe-1b-7b").reduced()
    assert rcfg.dtype == "float32" and rcfg.head_dim_ == 32
    rparams = models.init_params(rcfg, seed=0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    rx = torch.randn((128, rcfg.d_model), generator=gen, device=device)
    f32_expert_checks(rparams["layers"][0]["moe"], rcfg, rx, flush,
                      "reduced", per)
    f32_quant_checks(rparams["layers"][0]["moe"], rcfg, rx, flush,
                     "reduced", per)
    f32_attention_checks(rcfg.num_heads, rcfg.num_kv_heads, rcfg.head_dim_,
                         F32_REDUCED_LENS, 128, 128, None, device, flush,
                         "reduced", per)
    f32_attention_checks(rcfg.num_heads, 2, rcfg.head_dim_,
                         F32_REDUCED_LENS, 64, 128, 40, device, flush,
                         "reduced_gqa_window", per)
    q, k, v = (torch.randn((2, 128, h, 32), generator=gen, device=device,
                           dtype=torch.bfloat16).transpose(1, 2)
               for h in (4, 2, 2))
    for window in (None, 40):
        compare_rows(f"flash_attention_bf16_hd32_w{window}",
                     flash_attention(q, k, v, window=window),
                     flash_attention_plain(q, k, v, window=window),
                     shape=[2, 4, 2, 128, 32], window=window)
    del rparams
    f32_layer = {n: t.float() for n, t in layer.items()}
    f32_expert_checks(f32_layer, cfg, x.float(), flush, "olmoe", per,
                      witness=True,
                      x_fwd=None if x_fwd is None else x_fwd.float())
    f32_quant_checks(f32_layer, cfg, x.float(), flush, "olmoe", per)
    del f32_layer
    f32_attention_checks(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                         F32_LENS, 512, 512, None, device, flush, "olmoe",
                         per)
    f32_mla_checks(flush, device, per)
    torch.cuda.empty_cache()
    wcfg = get_config(F32_QUANT_WIDE).with_(num_layers=2)
    wparams = models.init_params(wcfg, seed=0, device=device)
    wlayer = cast_tree(next(lp["moe"] for lp in wparams["layers"]
                            if "moe" in lp), torch.float32)
    del wparams
    wx = torch.randn((512, wcfg.d_model), generator=gen, device=device)
    f32_quant_checks(wlayer, wcfg, wx, flush, FAMILY_SHORT[F32_QUANT_WIDE],
                     per)
    f32_ffn_wide(wlayer, wx, FAMILY_SHORT[F32_QUANT_WIDE])
    del wlayer, wx
    gc.collect()
    torch.cuda.empty_cache()
    return per


def f32_logits_gate(check, got, plain, bf16_rows, **extra):
    """The f32 kernel path's first-token logits rows (uid -> row) against
    the plain f32 path's: each row within F32_LOGITS_TOL, and the largest
    row error at most F32_RATIO times the bf16 kernel path's largest."""
    uids = sorted(plain)
    if sorted(got) != uids or sorted(bf16_rows) != uids:
        raise AssertionError(f"{check}: first-token rows of {sorted(got)} / "
                             f"{sorted(bf16_rows)} against {uids}")
    stack = [torch.stack([rows[u] for u in uids]) for rows in
             (got, plain, bf16_rows)]
    rec = {"check": check, "rows": len(uids), "tol": F32_LOGITS_TOL,
           "ratio_limit": F32_RATIO,
           "f32_kernel_vs_f32_plain": row_rel_err(stack[0],
                                                   stack[1]).max().item(),
           "bf16_kernel_vs_f32_plain": row_rel_err(stack[2],
                                                    stack[1]).max().item(),
           "argmax_equal": (stack[0].argmax(-1) == stack[1].argmax(-1))
           .float().mean().item(),
           "finite": bool(torch.isfinite(stack[0]).all()), **extra}
    rec["ratio"] = (rec["f32_kernel_vs_f32_plain"]
                    / max(rec["bf16_kernel_vs_f32_plain"], 1e-30))
    emit(rec)
    if not (rec["finite"] and rec["f32_kernel_vs_f32_plain"] <= F32_LOGITS_TOL
            and rec["ratio"] <= F32_RATIO):
        raise AssertionError(f"{check} failed: {rec}")


#: the depth (in MoE layers) of the serves whose first-token logits
#: ``f32_logits_gate`` holds: through more layers a top-k near tie in any
#: token's routing, which f32 sums in another order can flip, reaches the
#: last token through attention and moves its logits by their own size
#: (the contiguous serve at 16 layers: one row of 8 by 0.305, its argmax
#: changed; ``first_route_split`` found the flip at layer 1, a gap of
#: 5.4e-7 between the 8th and 9th router logits, inside the two paths'
#: 2.8e-6 distance there); through the first layer only the last token's
#: own routing counts (``reference_check`` cuts to one layer for the same
#: reason).  On ``dense`` the first split is not a near tie: a decode
#: step's idle rows attend to zeros on the kernel path and to the mean of
#: their masked slots on the plain path (as the reference's kernel and
#: plain paths), and take capacity slots there (ROADMAP C14)
F32_GATE_LAYERS = 1


def cast_tree(x, dtype):
    """Every float tensor of a params tree as ``dtype`` (a copy)."""
    if isinstance(x, dict):
        return {k: cast_tree(v, dtype) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(cast_tree(v, dtype) for v in x)
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    return x


@contextmanager
def routing_log():
    """Record every ``route`` call's router logits [T, E] (f32) and top-k
    ids while the block runs, in call order (the MoE impls' own references
    to ``route`` wrapped; eager steps only: a graph's replay runs no
    Python)."""
    import importlib
    mods = [importlib.import_module(f"repro_torch.models.moe.{m}")
            for m in ("dense", "gmm", "decode")]
    log, orig = [], {m: m.route for m in mods}

    def wrap(fn):
        def logged(params, cfg, x2d, top_k, k_budget=None):
            out = fn(params, cfg, x2d, top_k, k_budget=k_budget)
            log.append((x2d.float() @ params["router"].float(), out[1]))
            return out
        return logged
    for m in mods:
        m.route = wrap(orig[m])
    try:
        yield log
    finally:
        for m in mods:
            m.route = orig[m]


#: a row whose two paths' router logits lie within this share of the
#: row's largest logit has the same input up to f32 summation order
SAME_INPUT = 1e-4


def first_route_split(kernel_log, plain_log, top_k, moe_layers):
    """C13: where the kernel path's routing first differs from the plain
    path's (``route`` calls in order: the call, its MoE layer, a row whose
    top-k set differs).  ``first``: the first such row at all, with
    ``inputs_apart`` when the two paths' logits of that row lie further
    apart than SAME_INPUT (its input already differed: not a near tie);
    ``first_same_input``: the first such row whose input was the same up
    to summation order.  Each with the plain path's gap between its k-th
    and (k+1)-th logit, that gap over the k-th logit's size, and the two
    paths' logit distance there: a flip whose gap lies inside that
    distance is a near tie."""
    out = {"calls": min(len(kernel_log), len(plain_log)), "first": None,
           "first_same_input": None}
    for i, ((lk, ik), (lp, ip)) in enumerate(zip(kernel_log, plain_log)):
        if ik.shape != ip.shape:
            out["shapes_differ"] = {"call": i, "shapes": [list(ik.shape),
                                                          list(ip.shape)]}
            break
        split = (ik.sort(-1).values != ip.sort(-1).values).any(-1)
        dist = (lk - lp).abs().amax(-1)
        same = dist <= SAME_INPUT * lp.abs().amax(-1)
        for key, rows in (("first", split), ("first_same_input",
                                             split & same)):
            if out[key] is None and rows.any():
                row = int(rows.nonzero()[0])
                top = lp[row].sort(descending=True).values
                gap = (top[top_k - 1] - top[top_k]).item()
                out[key] = {
                    "call": i, "layer": i % moe_layers, "row": row,
                    "rows_split": int(split.sum()),
                    "inputs_apart": not bool(same[row]),
                    "logit_k": top[top_k - 1].item(), "gap": gap,
                    "gap_rel": gap / max(abs(top[top_k - 1].item()), 1e-30),
                    "kernel_vs_plain_logits": dist[row].item()}
        if out["first_same_input"] is not None:
            break
    return out


def serve_f32_layout(tag, cfg32, params, make, bf16_rows, kernels_run,
                     device, warm=False, routing=False):
    """One full-width f32 serve of the 8 requests (``make(cfg, params,
    graphs, kernels)`` builds the engine): at full depth through the
    kernels graphed (tokens, launches) and its eager twin (equal tokens
    and launches), and on the plain f32 paths; the first-token rows'
    distances at full depth printed (the kernel path's and, given,
    ``bf16_rows``', the bf16 kernel path's of the same serve, from the
    plain f32 path's); with ``routing``, where the eager twin's routing
    first splits from an eager plain serve's, their warm-up waves
    included (``first_route_split``);
    then the same serve through its first F32_GATE_LAYERS MoE layers (and
    the dense layers before them), through the f32 kernels, on the plain
    f32 paths and through the bf16 kernels (the same weights rounded to
    bf16), its rows held by ``f32_logits_gate``.  ``warm``: each engine
    serves the same warm-up wave first (``dense``: a pad row's routing
    follows its recycled pages' stale bytes, so every engine walks the
    same history).  Returns (record, need)."""
    def served(c, p, graphs, kernels, log=False):
        eng = make(c, p, graphs, kernels)
        with routing_log() if log else nullcontext() as got_log:
            if warm:
                eng.serve(requests(c, seed=0))
            else:
                eng.serve(requests(c, seed=0, n=2, max_new=4))   # warm-up
            with first_token_rows(eng) as rows:
                res, counts = counted(lambda: eng.serve(requests(c, seed=0)))
        stats = serve_record(eng)
        del eng
        gc.collect()                    # the engine's pool and weights
        return res, counts, rows, stats, got_log
    res, counts, rows, stats, _ = served(cfg32, params, True, True)
    check_results(f"f32 {tag}", res, cfg32, max_new=32)
    rec = {"stats": stats, "launches": counts}
    res_e, counts_e, _, rec["eager_stats"], k_log = served(
        cfg32, params, False, True, routing)
    same_tokens(f"f32 {tag} graphed vs eager", res, res_e)
    if counts_e != counts:
        raise AssertionError(f"f32 {tag}: eager launches {counts_e} against "
                             f"{counts}")
    _, plain_counts, plain_rows, rec["plain_stats"], _ = served(
        cfg32, params, True, False)
    if any(plain_counts.values()):
        raise AssertionError(f"f32 {tag} plain: launches {plain_counts}")
    uids = sorted(plain_rows)
    want = torch.stack([plain_rows[u] for u in uids])
    rec["full_depth"] = {
        "layers": cfg32.num_layers,
        "f32_kernel_vs_f32_plain": row_rel_err(torch.stack(
            [rows[u] for u in uids]), want).tolist()}
    if bf16_rows is not None:
        rec["full_depth"]["bf16_kernel_vs_f32_plain"] = row_rel_err(
            torch.stack([bf16_rows[u] for u in uids]), want).tolist()
    if routing:
        p_log = served(cfg32, params, False, False, True)[4]
        rec["full_depth"]["first_route_split"] = first_route_split(
            k_log, p_log, cfg32.moe_top_k, cfg32.num_moe_layers)
        del k_log, p_log
    n = cfg32.first_k_dense + F32_GATE_LAYERS
    cut = cfg32.with_(num_layers=n)
    p_cut = dict(params, layers=params["layers"][:n])
    got = served(cut, p_cut, True, True)[2]
    plain = served(cut, p_cut, True, False)[2]
    b_rows = served(cut.with_(dtype="bfloat16"),
                    cast_tree(p_cut, torch.bfloat16), True, True)[2]
    torch.cuda.empty_cache()
    f32_logits_gate(f"serve_f32_{tag}_first_token_logits", got, plain,
                    b_rows, layers=n)
    return rec, {f"f32_{tag}": (counts, kernels_run),
                 f"f32_{tag}_eager": (counts_e, kernels_run)}


def forward_f32(params, cfg32, plan, device):
    """Fig. 4's rows on ``gmm`` in f32 (the baseline and the plan):
    ``loss_fn`` on 4 x 512 tokens through B1 and B2, a CUDA graph each,
    against the plain f32 paths eagerly; cross-entropy within RECIPE_TOL
    relative; median ms of 3 interleaved calls each.  Returns (record,
    the kernel forwards' launches)."""
    from repro_torch import models
    from repro_torch.core import apply_plan_params
    from repro_torch.launch.forward import Forward, graph_context, make_batch
    batch = make_batch(cfg32, 4, 512, seed=4, device=device)
    cfg_l, params_l = apply_plan_params(params, cfg32, plan)
    ctx = graph_context(device)
    kern = models.ModelOpts(use_flash=True, use_moe_kernel=True)
    fwds = {}
    for name, (p, c) in (("baseline", (params, cfg32)),
                         ("lexi", (params_l, cfg_l))):
        fwds[name] = Forward(p, c, batch, kern, ctx)
        fwds[f"{name}_plain"] = Forward(p, c, batch, models.ModelOpts())
    times, xent = {n: [] for n in fwds}, {}
    from repro_torch import kernels
    kernels.reset_launch_counts()
    for r in range(4):
        for n in (list(fwds) if r % 2 == 0 else list(fwds)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xent[n] = fwds[n]().item()
            torch.cuda.synchronize()
            if r:
                times[n].append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    rec = {"batch": [4, 512], "models": {
        n: {"xent": xent[n], "ms_median": statistics.median(times[n])}
        for n in fwds}}
    for name in ("baseline", "lexi"):
        rel = abs(xent[name] - xent[f"{name}_plain"]) / abs(
            xent[f"{name}_plain"])
        rec["models"][name]["xent_rel_to_plain"] = rel
        if not np.isfinite(xent[name]) or rel > RECIPE_TOL:
            raise AssertionError(f"forward f32 {name}: xent {xent[name]} "
                                 f"against plain {xent[f'{name}_plain']}")
    del fwds
    torch.cuda.empty_cache()
    return rec, counts


def serve_f32_phase(params, cfg, plan, bf16_rows, device, t_start):
    """Phase 7b's serves (module doc): full-width, full-depth OLMoE-1B-7B
    in f32 (the bf16 weights cast in place, ``as_f32``), served paged on
    ``gmm`` (B1, B3, B4), contiguous with whole prompts (B2, B8, and B1 /
    B3 on ``gmm``), paged on ``dense`` (B9, B4), and paged on ``gmm`` with
    int8 and int4 experts quantized at load (B6, B5, B4), each gated by
    ``serve_f32_layout`` (against ``bf16_rows``, the bf16 kernel path's
    first-token rows of the same serve where there are: "paged",
    "contiguous", "dense"; the contiguous and dense serves also locate
    their first routing split, C13); then Fig. 4's ``gmm`` rows
    (``forward_f32``).  Returns the launch needs."""
    from repro_torch import models
    from repro_torch.serving import Engine
    from repro_torch.tree import leaves
    need = {}
    rec = {"phase": "serve_f32", "allow_tf32": {
        "matmul": torch.backends.cuda.matmul.allow_tf32,
        "cudnn": torch.backends.cudnn.allow_tf32}}
    if rec["allow_tf32"]["matmul"] or rec["allow_tf32"]["cudnn"]:
        raise AssertionError(f"serve_f32: TF32 is on {rec['allow_tf32']}")
    t0 = time.perf_counter()
    with as_f32(params):
        gmm32 = cfg.with_(moe_impl="gmm", dtype="float32")
        dense32 = cfg.with_(moe_impl="dense", dtype="float32")
        rec["params_gb"] = sum(t.numel() * t.element_size()
                               for t in leaves(params)) / 1e9

        def paged(c, p, graphs, kernels, expert_dtype="bf16"):
            return Engine(c, p, max_batch=8, max_len=512,
                          prefill_chunk=64, use_kernel=kernels,
                          use_moe_decode=kernels, opts=models.ModelOpts(
                              use_moe_kernel=kernels), device=device,
                          graphs=graphs, expert_dtype=expert_dtype)

        def contiguous(c, p, graphs, kernels):
            return Engine(c, p, max_batch=8, max_len=512,
                          cache_layout="contiguous", prefill_chunk=0,
                          use_moe_decode=kernels, opts=models.ModelOpts(
                              use_flash=kernels, use_flash_decode=kernels,
                              use_moe_kernel=kernels), device=device,
                          graphs=graphs)
        quant = ("moe_gmm_quant", "moe_decode_quant", "flash_decode_paged")
        for tag, c, make, run, warm in (
                ("paged", gmm32, paged,
                 ("moe_gmm", "moe_decode", "flash_decode_paged"), False),
                ("contiguous", gmm32, contiguous,
                 ("moe_gmm", "moe_decode", "flash_attention",
                  "flash_decode"), False),
                ("dense", dense32, paged,
                 ("moe_ffn", "flash_decode_paged"), True),
                *((f"paged_{dt}", gmm32, partial(paged, expert_dtype=dt),
                   quant, False) for dt in ("int8", "int4"))):
            rec[tag], n = serve_f32_layout(
                tag, c, params, make, bf16_rows.get(tag), run, device, warm,
                routing=tag in ("contiguous", "dense"))
            need.update(n)
            rec[f"{tag}_seconds"] = time.perf_counter() - t0
        rec["forward"], counts = forward_f32(params, gmm32, plan, device)
        need["forward_f32"] = (counts, ("moe_gmm", "flash_attention"))
    rec.update(seconds=time.perf_counter() - t0,
               seconds_total=time.perf_counter() - t_start, card=card_line())
    emit(rec)
    return need


def serve_f32_mla_phase(params, cfg, device, t_start):
    """Phase 9a: full-depth DeepSeek-V2-Lite with f32 weights but for its
    routed experts (cast in place, ``as_f32``), which the engine quantizes
    to int8 at load from their bf16 values, served paged on ``gmm`` (B6,
    B5, and B7 on an f32 latent pool) by ``serve_f32_layout``: graphed,
    eager and plain at full depth, then gated through its dense first
    layer and its first MoE layer.  Prints the phase's peak.  Returns the
    launch needs."""
    from repro_torch import models
    from repro_torch.serving import Engine
    gmm32 = cfg.with_(moe_impl="gmm", dtype="float32")
    experts = [lp["moe"][w] for lp in params["layers"] if "moe" in lp
               for w in ("w1", "w2")]

    def paged(c, p, graphs, kernels):
        return Engine(c, p, max_batch=8, max_len=512, prefill_chunk=64,
                      use_kernel=kernels, use_moe_decode=kernels,
                      expert_dtype="int8", opts=models.ModelOpts(
                          use_moe_kernel=kernels), device=device,
                      graphs=graphs)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(device)
    with as_f32(params, keep=experts):
        rec, need = serve_f32_layout(
            "mla_int8", gmm32, params, paged, None,
            ("moe_gmm_quant", "moe_decode_quant", "flash_decode_paged_mla"),
            device)
    for step, (counts, _) in need.items():
        if counts["moe_gmm"] or counts["moe_decode"] or any(
                counts[n] for n in GQA_ATTENTION):
            raise AssertionError(f"{step}: launches {counts}")
    rec.update(peak_gb=torch.cuda.max_memory_allocated(device) / 1e9)
    del experts
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve_f32_mla", **rec, "layers": cfg.num_layers,
          "seconds": time.perf_counter() - t0,
          "seconds_total": time.perf_counter() - t_start, "card": card_line()})
    return need


def reduced_launchers_phase(device, t_start):
    """The reduced OLMoE and DeepSeek-V2-Lite configs (f32, d 128; OLMoE
    hd 32, DeepSeek MLA at r 32, dr 16) through the port's own entry
    points on the card, in this process, each counted:
    ``launch/serve.py`` on OLMoE on ``dense`` (B9, B4), on ``gmm`` with the
    fused decode and a LExI plan (B1 in Alg. 1 and the chunks, B3, B4), on
    the contiguous layout with whole prompts (B2, B8, B9), on ``gmm`` with
    int8 and int4 experts (B6, B5, B4); on DeepSeek paged on ``gmm`` with
    the fused decode (B1, B3, B7 on the f32 latent pool), again with int4
    experts (B6, B5, B7); and ``launch/serve_lexi.py`` (Alg. 1 through B1,
    held-out eval through B1 and B2, the engine through B1, B3 and B4),
    again with int8 experts (eval through B6 and B2, the engine through
    B6, B5 and B4).  Each must exit 0 and launch its kernels.  Returns the
    launch needs."""
    from repro_torch.launch import serve, serve_lexi
    base = ["--arch", "olmoe-1b-7b", "--reduced", "--requests", "4",
            "--max-new", "8", "--max-len", "96"]
    gmm = ["--use-kernel", "--use-moe-kernel", "--moe-impl", "gmm",
           "--use-moe-decode"]
    mla = ["--arch", "deepseek-v2-lite"] + base[2:] + gmm
    quant = ("moe_gmm_quant", "moe_decode_quant")
    runs = {
        "serve_dense": (serve.main, base + ["--use-kernel",
                                            "--use-moe-kernel"],
                        ("moe_ffn", "flash_decode_paged")),
        "serve_gmm": (serve.main, base + [
            "--use-kernel", "--use-moe-kernel", "--moe-impl", "gmm",
            "--use-moe-decode", "--lexi-budget-frac", "0.5"],
            ("moe_gmm", "moe_decode", "flash_decode_paged")),
        "serve_contiguous": (serve.main, base + [
            "--cache-layout", "contiguous", "--prefill-chunk", "0",
            "--use-flash", "--use-flash-decode", "--use-moe-kernel"],
            ("flash_attention", "flash_decode", "moe_ffn")),
        "serve_lexi": (serve_lexi.main, ["--steps", "40", "--requests", "4",
                                         "--max-new", "6"],
                       ("moe_gmm", "moe_decode", "flash_decode_paged",
                        "flash_attention")),
        **{f"serve_gmm_{dt}": (serve.main, base + gmm + ["--expert-dtype",
                                                         dt],
                               quant + ("flash_decode_paged",))
           for dt in ("int8", "int4")},
        "serve_mla": (serve.main, mla, ("moe_gmm", "moe_decode",
                                        "flash_decode_paged_mla")),
        "serve_mla_int4": (serve.main, mla + ["--expert-dtype", "int4"],
                           quant + ("flash_decode_paged_mla",)),
        "serve_lexi_int8": (serve_lexi.main, [
            "--steps", "40", "--requests", "4", "--max-new", "6",
            "--expert-dtype", "int8"],
            quant + ("flash_decode_paged", "flash_attention")),
    }
    rec, need = {"phase": "reduced_f32"}, {}
    for tag, (fn, argv, kernels_run) in runs.items():
        argv = argv + ["--device", device.type]
        t0 = time.perf_counter()
        rc, counts = counted(lambda: fn(argv))
        if rc != 0:
            raise AssertionError(f"reduced {tag} {argv}: exit {rc}")
        rec[tag] = {"argv": argv, "exit": rc, "launches": counts,
                    "seconds": time.perf_counter() - t0}
        need[f"reduced_{tag}"] = (counts, kernels_run)
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


# --------------------------------------------------------------------------- #
# phase 9b: five more architectures at full width
# --------------------------------------------------------------------------- #

#: the families phase's depth a config: 8 of qwen3-moe's 94 layers (2.49 B
#: parameters a layer) and of llama4-scout's 48 (2.20 B), so their bf16
#: weights (42.3 and 39.4 GB) leave room on the 80 GB card; the others
#: run at full depth (qwen3-32b 65.5 GB)
FAMILY_LAYERS = {"qwen3-moe-235b-a22b": 8, "llama4-scout-17b-a16e": 8}
#: danube's window on its contiguous serve: under the prompts' 32-256
#: tokens, so the ring wraps and every kernel applies the window (its own
#: 4096 exceeds the serve's max_len of 512)
FAMILY_WINDOW = 128
#: tokens each request decodes in the families phase (the serve phases'
#: 32 halved, to keep the phase short)
FAMILY_NEW = 16
#: the families that serve the 8 requests again with int8 and int4
#: experts (quantized at load on a ``gmm`` copy of the config):
#: llama4-scout's F 8192 runs B5's pass 2 in two chunks of h rows
FAMILY_QUANT = ("llama4-scout-17b-a16e",)
#: the short name of a family in step and check names
FAMILY_SHORT = {"qwen3-moe-235b-a22b": "qwen3_moe",
                "llama4-scout-17b-a16e": "llama4",
                "qwen3-32b": "qwen3_32b", "h2o-danube-1.8b": "danube",
                "minicpm3-4b": "minicpm3", "olmo-1b": "olmo",
                "pixtral-12b": "pixtral", "mamba2-780m": "mamba2",
                "zamba2-1.2b": "zamba2", "whisper-base": "whisper"}


@contextmanager
def forbid_sdpa():
    """Make the model's plain masked-softmax attention raise on the card
    while the block runs (``gqa_attention`` looks ``_sdpa`` up at each
    call): every attention of the block must go through a kernel."""
    from repro_torch.models import attention
    plain = attention._sdpa

    def guard(q, *a, **kw):
        if q.is_cuda:
            raise AssertionError("the plain attention ran on the card")
        return plain(q, *a, **kw)
    attention._sdpa = guard
    try:
        yield
    finally:
        attention._sdpa = plain


def prefix_check(params, cfg, device):
    """Pixtral's VLM path: a whole prefill of ``prefix_embed_len`` (1024)
    random patch embeddings plus a 64-token prompt, 2 rows, through
    ``flash_attention``, then a decode step at position 1024 + 64 through
    ``flash_decode``, with no plain attention on the kernel side, one
    launch of each a layer, held by ``depth_gate``: at full depth to an f32
    witness, and through the model cut to its first layer, as
    ``family_reference`` holds every family, to the plain paths within
    LOGITS_TOL.  Returns the cut model's kernel-side launch counts."""
    from repro_torch import kernels, models
    b, s, plen = 2, 64, cfg.prefix_embed_len
    gen = torch.Generator(device="cpu")
    gen.manual_seed(4)
    pre = torch.randn((b, plen, cfg.d_model), generator=gen).to(device)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    nxt = torch.randint(0, cfg.vocab_size, (b,), generator=gen).int()
    tokens, nxt = tokens.to(device), nxt.to(device)
    pos = torch.full((b,), plen + s, dtype=torch.int32, device=device)

    def run(p, c, opts):
        caches = models.init_caches(c, b, plen + s + 8,
                                    layout="contiguous", device=device)
        lg1, caches = models.prefill_fn(
            p, c, {"tokens": tokens, "prefix_embeds": pre}, caches,
            opts=opts)
        lg2, _ = models.decode_fn(p, c, nxt, pos, caches, opts=opts)
        return {"prefix": (lg1.float(), lg2.float())}

    def kernel(p, c):             # counted: the counts start at 0 here
        got = run(p, c, models.ModelOpts(use_flash=True,
                                          use_flash_decode=True))
        counts = kernels.launch_counts()
        for n in ("flash_attention", "flash_decode"):
            if counts[n] != c.num_layers:
                raise AssertionError(f"{c.name} prefix: {n} {counts[n]} "
                                     "launches, want one a layer")
        return got
    return depth_gate(f"reference_logits_{cfg.name}", params, cfg, kernel,
                      lambda p, c: run(p, c, models.ModelOpts()), 1,
                      prefix=plen, prompt=s)


def family_expert_checks(layer, cfg, short, device, rows):
    """B1, B3 and B9 at a family's expert shapes (the first MoE layer's
    router and experts): B1 on 512 tokens, B3 on 8 tokens at top-k and at
    k 2, B9 on a decode step's capacity buffers (8 tokens); B5 (8 tokens,
    top-k and k 2) and B6 (512 tokens) on the same experts in int8 and
    int4 (``check_moe_decode_quant``, ``check_moe_gmm_quant``: channels
    scaled apart, quantized on the card); each held to its plain version
    and a sub-entry of its kernel's row."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    x = torch.randn((512, cfg.d_model), generator=gen, device=device,
                    dtype=torch.bfloat16)
    x8 = x[:8].contiguous()
    f = cfg.moe_d_ff
    shapes = {"moe_gmm": {f"{short}_f{f}": kernel_row(
        "moe_gmm", "", "", *check_moe_gmm(layer, cfg, x, flush,
                                          tag=f"_{short}"))}}
    shapes["moe_decode"] = {
        f"{short}_f{f}_{key}": kernel_row("moe_decode", "", "", *v)
        for key, v in check_moe_decode(layer, cfg, x8, flush,
                                       f"_{short}").items()}
    sh = f"{short}_decode_f{f}"
    shapes["moe_ffn"] = {sh: kernel_row(
        "moe_ffn", "", "", *check_moe_ffn(layer, cfg, x8, flush, sh))}
    # the plain versions gather every routed expert's weights in f32 (7.5
    # GB at qwen3-moe's 512 tokens): return the cached blocks first
    gc.collect()
    torch.cuda.empty_cache()
    shapes["moe_decode_quant"] = {
        f"{short}_f{f}_{key}": kernel_row("moe_decode_quant", "", "", *v)
        for key, v in check_moe_decode_quant(
            layer, cfg, x8, flush, f"_{short}",
            ks=(cfg.moe_top_k, 2)).items()}
    gc.collect()
    torch.cuda.empty_cache()
    shapes["moe_gmm_quant"] = {
        f"{short}_f{f}_{dt}": kernel_row("moe_gmm_quant", "", "", *v)
        for dt, v in check_moe_gmm_quant(layer, cfg, x, flush,
                                         f"_{short}").items()}
    for name, per in shapes.items():
        rows[name].setdefault("shapes", {}).update(
            {k: {n: r[n] for n in NESTED_KEYS if n in r}
             for k, r in per.items()})
    return shapes


def family_reference(params, cfg, device):
    """The kernel paths' logits against the plain paths' on the same
    weights, through the model cut to its first layer (``depth_gate``, no
    full-depth witness): a chunk step and a decode step on the paged pool
    (``paged_logits``; the MoE configs on a ``gmm`` copy, so ``moe_gmm``
    and ``moe_decode`` run), and for GQA a whole-prompt prefill on the
    contiguous cache and a decode step (``flash_attention``,
    ``flash_decode``), each row within LOGITS_TOL.  Returns the kernel
    side's launch counts."""
    from repro_torch import models
    if cfg.is_moe:
        cfg = cfg.with_(moe_impl="gmm")
    dev = ref_inputs(cfg, device)
    b, c = dev["tokens"].shape
    kern = models.ModelOpts(use_moe_kernel=True, use_paged_kernel=True,
                            use_moe_decode_kernel=True, use_flash=True,
                            use_flash_decode=True)
    plain = models.ModelOpts(use_moe_decode_kernel=True)

    def contiguous(p, cut, opts):
        caches = models.init_caches(cut, b, 2 * c, layout="contiguous",
                                    device=device)
        lg1, caches = models.prefill_fn(p, cut, {"tokens": dev["tokens"]},
                                        caches, opts=opts)
        lg2, _ = models.decode_fn(p, cut, dev["nxt"], dev["pos_c"], caches,
                                  opts=opts)
        return lg1.float(), lg2.float()

    def both(opts):
        def run(p, cut):
            out = {"paged": paged_logits(p, cut, opts, dev)}
            if cfg.attention == "gqa":
                out["contiguous"] = contiguous(p, cut, opts)
            return out
        return run
    return depth_gate(f"reference_logits_{cfg.name}", params, cfg,
                      both(kern), both(plain), 1, guard=False, witness=False)


def family_phase(name, cfg, device, t_start, rows):
    """One architecture at full width on the card (its depth cut per
    FAMILY_LAYERS): init, the expert kernels at its shapes (MoE), the
    reference check, the 8 requests served on the paged pool through its
    own ``dense`` impl (graphed; an eager twin's greedy tokens and launches
    equal; then the wave again, every step a replay: the steady numbers),
    the contiguous layout for a windowed or a dense GQA config
    (danube under FAMILY_WINDOW, qwen3-32b: whole prompts through
    ``flash_attention``, decode through ``flash_decode``); for a MoE config
    with top-k above 1 a LExI plan profiled at a 50 % budget and served,
    then a mixed wave of baseline and plan requests through the bucketed-k
    steps, each wave's tokens and launches equal to an eager twin's that
    served the same waves before it (on ``dense`` the capacity drops
    follow the pool's past; the mixed wave's agreement with the
    single-plan serves is printed, not gated: rows of other plans compete
    for capacity);
    for a top-1 config the identity plan asserted.  Returns {step: (launch
    counts, kernels the step must launch)}."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core import optimize
    from repro_torch.serving import Engine
    from repro_torch.tree import leaves
    short = FAMILY_SHORT.get(name, name)
    attn = ("flash_decode_paged_mla",) if cfg.attention == "mla" else \
        ("flash_decode_paged",)
    moe = ("moe_ffn",) if cfg.is_moe else ()
    need, rec = {}, {"phase": "families", "arch": name,
                     "layers": cfg.num_layers,
                     "full_layers": get_config(name).num_layers}
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    hd = cfg.head_dim_
    rec.update(init_s=time.perf_counter() - t0,
               params_gb=sum(t.numel() * t.element_size()
                             for t in leaves(params)) / 1e9,
               kv_bytes_per_token=cfg.num_layers * 2 * (
                   cfg.kv_lora_rank + cfg.qk_rope_head_dim
                   if cfg.attention == "mla"
                   else 2 * cfg.num_kv_heads * hd),
               heads=[cfg.num_heads, cfg.num_kv_heads, hd])
    if cfg.is_moe:
        moe_layer = next(lp["moe"] for lp in params["layers"] if "moe" in lp)
        family_expert_checks(moe_layer, cfg, short, device, rows)
        del moe_layer

    counts = family_reference(params, cfg, device)
    ref_names = attn + (("moe_gmm", "moe_decode") if cfg.is_moe else ())
    if cfg.attention == "gqa":
        ref_names += ("flash_attention", "flash_decode")
    need[f"{short}_reference"] = (counts, ref_names)
    if cfg.prefix_embed_len:
        need[f"{short}_prefix"] = (prefix_check(params, cfg, device),
                                   ("flash_attention", "flash_decode"))

    def reqs(plans=None):
        return requests(cfg, seed=0, max_new=FAMILY_NEW, plans=plans)

    def paged(graphs=True):
        return Engine(cfg, params, max_batch=8, max_len=512,
                      prefill_chunk=64, use_kernel=True, use_moe_decode=True,
                      opts=models.ModelOpts(use_moe_kernel=True),
                      device=device, graphs=graphs)
    eng = paged()
    res_base, c = counted(lambda: eng.serve(reqs()))
    check_results(f"{name} serve", res_base, cfg, FAMILY_NEW)
    need[f"{short}_serve"] = (c, attn + moe)
    rec["serve_stats"] = serve_record(eng)
    rec["serve_launches"] = {n: v for n, v in c.items() if v}
    rec["serve_eager_stats"], c = eager_twin(f"{name} serve", paged, reqs(),
                                             res_base, c)
    need[f"{short}_serve_eager"] = (c, attn + moe)
    # the same wave again: every step a replay (the first serve captured
    # its keys), the steady graphed numbers
    res, c = counted(lambda: eng.serve(reqs()))
    check_results(f"{name} serve steady", res, cfg, FAMILY_NEW)
    need[f"{short}_serve_steady"] = (c, attn + moe)
    rec["serve_steady_stats"] = serve_record(eng)
    if rec["serve_steady_stats"]["graphs_captured"]:
        raise AssertionError(f"{name}: the steady serve captured a graph")

    if cfg.is_moe and cfg.moe_top_k > 1:
        budget = int(0.5 * cfg.num_moe_layers * cfg.moe_top_k)
        t0 = time.perf_counter()
        plan, c = counted(lambda: optimize(
            params, cfg.with_(moe_impl="gmm"), budget, method="dp",
            n_iter=2, profile_batch=2, profile_seq=32, seed=0,
            device=device, use_kernel=True))
        need[f"{short}_optimize"] = (c, ("moe_gmm",))
        rec.update(plan=list(plan.plan), budget=budget,
                   optimize_s=time.perf_counter() - t0)
        if sum(plan.plan) != budget:
            raise AssertionError(f"{name}: plan {plan.plan} at {budget}")
        eng.add_plan("lexi", plan)
        res_lexi, c = counted(lambda: eng.serve(reqs(), plan="lexi"))
        check_results(f"{name} lexi", res_lexi, cfg, FAMILY_NEW)
        need[f"{short}_lexi"] = (c, attn + moe)
        rec["lexi_stats"] = serve_record(eng)

        # the eager twin walks the same history (the baseline waves, then
        # the plan's, then the mixed one): on dense a pad row attends the
        # stale bytes of its recycled pages, so its routing, and the copies
        # it drops, follow the pool's past
        twin = paged(graphs=False)
        twin.add_plan("lexi", plan)
        twin.serve(reqs())
        twin.serve(reqs())
        res, c2 = counted(lambda: twin.serve(reqs(), plan="lexi"))
        same_tokens(f"{name} lexi graphed vs eager", res_lexi, res)
        if c2 != c:
            raise AssertionError(f"{name} lexi: eager launches {c2} against "
                                 f"the graphed serve's {c}")
        rec["lexi_eager_stats"] = serve_record(twin)
        mix = ["base" if i % 2 == 0 else "lexi" for i in range(8)]
        res_mix, c = counted(lambda: eng.serve(reqs(plans=mix)))
        check_results(f"{name} mixed", res_mix, cfg, FAMILY_NEW)
        need[f"{short}_mixed"] = (c, attn + moe)
        rec["mixed_stats"] = serve_record(eng)
        res, c2 = counted(lambda: twin.serve(reqs(plans=mix)))
        same_tokens(f"{name} mixed graphed vs eager", res_mix, res)
        if c2 != c:
            raise AssertionError(f"{name} mixed: eager launches {c2} against "
                                 f"the graphed serve's {c}")
        rec["mixed_agreement_with_single_plan"] = agreement(
            res_mix, [(res_base if p == "base" else res_lexi)[i]
                      for i, p in enumerate(mix)])
        del twin
        if rec["mixed_stats"]["mixed_plan_steps"] <= 0:
            raise AssertionError(f"{name}: no mixed-plan step")
    elif cfg.is_moe:
        plan = optimize(params, cfg, cfg.num_moe_layers, method="dp",
                        device=device)
        if tuple(plan.plan) != (1,) * cfg.num_moe_layers:
            raise AssertionError(f"{name}: top-1 plan {plan.plan}")
        rec["plan"] = list(plan.plan)
    drained(f"{name} serve", eng)
    del eng
    torch.cuda.empty_cache()
    if name in FAMILY_QUANT:
        need.update(family_quant_serve(params, cfg, short, device, rec,
                                       reqs))

    if cfg.attention == "gqa" and (cfg.sliding_window or not cfg.is_moe):
        cfg_c = cfg.with_(sliding_window=FAMILY_WINDOW) \
            if cfg.sliding_window else cfg

        def contiguous(graphs=True):
            return Engine(cfg_c, params, max_batch=8, max_len=512,
                          cache_layout="contiguous", prefill_chunk=0,
                          use_moe_decode=True, opts=models.ModelOpts(
                              use_flash=True, use_flash_decode=True,
                              use_moe_kernel=True), device=device,
                          graphs=graphs)
        eng = contiguous()
        with forbid_sdpa():       # whole prompts and decode: kernels only
            res, c = counted(lambda: eng.serve(reqs()))
        check_results(f"{name} contiguous", res, cfg, FAMILY_NEW)
        need[f"{short}_contiguous"] = (c, ("flash_attention", "flash_decode")
                                       + moe)
        rec.update(contiguous_window=cfg_c.sliding_window,
                   contiguous_stats=serve_record(eng),
                   contiguous_launches={n: v for n, v in c.items() if v})
        rec["contiguous_eager_stats"], _ = eager_twin(
            f"{name} contiguous", contiguous, reqs(), res, c)
        res, c = counted(lambda: eng.serve(reqs()))
        check_results(f"{name} contiguous steady", res, cfg, FAMILY_NEW)
        need[f"{short}_contiguous_steady"] = (
            c, ("flash_attention", "flash_decode") + moe)
        rec["contiguous_steady_stats"] = serve_record(eng)
        del eng
    del params
    gc.collect()                      # a runner's graphs, pools and caches
    torch.cuda.empty_cache()
    rec["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    rec["launches"] = {k[len(short) + 1:]: {n: v for n, v in c.items() if v}
                       for k, (c, _) in need.items()}
    emit(dict(rec, seconds_total=time.perf_counter() - t_start))
    return need


def family_quant_serve(params, cfg, short, device, rec, reqs):
    """The 8 requests on the paged pool with int8, then int4 experts
    (``Engine(expert_dtype=)`` quantizes the routed experts at load on a
    ``gmm`` copy of the config; the bf16 weights and one quantized copy
    are held together, each quantized engine freed before the next),
    graphed, then eagerly: tokens and launches equal, ``moe_gmm_quant``
    and ``moe_decode_quant`` launched, no bf16 expert kernel.  Returns
    the launch needs."""
    from repro_torch import models
    from repro_torch.models.moe import QUANT_DTYPES
    from repro_torch.serving import Engine
    cfg_q = cfg.with_(moe_impl="gmm")
    kernels = ("moe_gmm_quant", "moe_decode_quant", "flash_decode_paged")
    need = {}
    for dt in QUANT_DTYPES:
        def paged(graphs=True):
            return Engine(cfg_q, params, max_batch=8, max_len=512,
                          prefill_chunk=64, use_kernel=True,
                          use_moe_decode=True, expert_dtype=dt,
                          opts=models.ModelOpts(use_moe_kernel=True),
                          device=device, graphs=graphs)
        eng = paged()
        res, c = counted(lambda: eng.serve(reqs()))
        check_results(f"{cfg.name} {dt}", res, cfg, FAMILY_NEW)
        for n in ("moe_gmm", "moe_decode", "moe_ffn"):
            if c[n]:
                raise AssertionError(f"{cfg.name} {dt}: the bf16 expert "
                                     f"kernel {n} ran {c[n]} times")
        moe = [lp["moe"] for lp in eng.runner.params["layers"]
               if "moe" in lp]
        line = {"stats": serve_record(eng),
                "launches": {n: v for n, v in c.items() if v},
                "expert_gb": sum(m[w].numel() * m[w].element_size()
                                 for m in moe for w in ("w1", "w2")) / 1e9}
        need[f"{short}_{dt}"] = (c, kernels)
        drained(f"{cfg.name} {dt}", eng)
        del eng, moe
        gc.collect()
        torch.cuda.empty_cache()
        line["eager_stats"], c = eager_twin(f"{cfg.name} {dt}", paged,
                                            reqs(), res, c)
        need[f"{short}_{dt}_eager"] = (c, kernels)
        gc.collect()
        torch.cuda.empty_cache()
        rec[f"serve_{dt}"] = line
    return need


def families_phase(device, t_start, rows):
    """Phase 9b: each of ``repro_torch.configs.FAMILIES`` in turn, its
    weights and engines freed before the next."""
    from repro_torch.configs import FAMILIES, get_config
    need = {}
    for name in FAMILIES:
        cfg = get_config(name)
        cfg = cfg.with_(num_layers=FAMILY_LAYERS.get(name, cfg.num_layers))
        need.update(family_phase(name, cfg, device, t_start, rows))
    return need


# --------------------------------------------------------------------------- #
# phase 9c: the stateful stacks and the encoder-decoder at full width
# --------------------------------------------------------------------------- #

#: the SSM stacks' serve: 8 requests of 32-256 prompt tokens (never over
#: the SSD chunk of 256, so every length is one the SSD takes) and
#: FAMILY_NEW tokens each
SSM_STACKS = ("mamba2-780m", "zamba2-1.2b")
#: whisper: rows, decoder prompt tokens and greedy decode steps
WHISPER_ROWS, WHISPER_PROMPT, WHISPER_STEPS = 8, 4, 16


#: the SSM reference check's cut: zamba2's first 6 layers hold 5 Mamba2
#: blocks and its first shared attention block
SSM_REF_LAYERS = 6


def ssm_reference(params, cfg, device):
    """Prefill of 63 tokens then one decode step, 2 rows, through the
    kernel options (zamba2's shared attention: ``flash_attention``,
    ``flash_decode``; no plain attention), against a train-mode forward of
    the 64 tokens on the plain paths: the prefill logits at position 62
    and the decode logits at 63, held by ``depth_gate``: at full depth to
    an f32 witness (the train-mode forward in f32), and through the model
    cut to its first SSM_REF_LAYERS layers to the bf16 forward within
    LOGITS_TOL.  Returns the cut model's kernel-side launch counts."""
    from repro_torch import models
    from repro_torch.models import transformer
    tokens = ref_inputs(cfg, device)["tokens"]
    b, s = tokens.shape
    key = "prefill_decode_vs_train"

    def kernel(p, c):
        caches = models.init_caches(c, b, 2 * s, layout="contiguous",
                                    device=device)
        opts = models.ModelOpts(use_flash=True, use_flash_decode=True)
        lg1, caches = models.prefill_fn(p, c, {"tokens": tokens[:, :-1]},
                                        caches, opts=opts)
        lg2, _ = models.decode_fn(p, c, tokens[:, -1].int(),
                                  torch.full((b,), s - 1, dtype=torch.int32,
                                             device=device), caches,
                                  opts=opts)
        return {key: (lg1.float(), lg2.float())}

    def train(p, c):
        with torch.no_grad():
            pos = torch.arange(s, dtype=torch.int32,
                               device=device).expand(b, s)
            hid, _, _ = transformer.forward(p, c, tokens, pos)
            full = transformer.lm_logits(p, c, hid[:, -2:]).float()
        return {key: (full[:, 0], full[:, 1])}
    return depth_gate(f"reference_logits_{cfg.name}", params, cfg, kernel,
                      train, SSM_REF_LAYERS)


def ssm_stack_phase(name, device, t_start):
    """One stack with mamba blocks at full width and depth, bf16, random
    weights drawn on the card: the reference check (``ssm_reference``),
    then the 8 requests on the contiguous engine (whole prompts, its
    default and only layout), graphed, with an eager twin whose tokens,
    launches and every decode logits row (bit for bit) are equal, then the
    wave again, every step a replay.  zamba2's shared attention runs
    ``flash_attention`` once an occurrence in each whole prefill and
    ``flash_decode`` once an occurrence in each decode step (6 at full
    depth), and no plain attention; mamba2 launches no kernel.  Returns
    {step: (launch counts, kernels the step must launch)}."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import _dims
    from repro_torch.serving import Engine
    from repro_torch.tree import leaves
    cfg = get_config(name)
    short = FAMILY_SHORT[name]
    kinds = [sp.kind for sp in cfg.pattern()]
    n_attn, n_mamba = kinds.count("shared_attn"), kinds.count("mamba")
    d_in, h, p, n, cc = _dims(cfg)
    attn = ("flash_attention", "flash_decode") if n_attn else ()
    need, rec = {}, {"phase": "ssm_encdec", "arch": name,
                     "layers": cfg.num_layers, "mamba_layers": n_mamba,
                     "shared_attn_layers": n_attn,
                     # conv rows (bf16) and the f32 SSM state, a slot
                     "state_bytes_per_slot": n_mamba * (
                         (cfg.ssm_conv_width - 1) * cc * 2 + h * p * n * 4),
                     "kv_bytes_per_token": n_attn * 2 * 2 * (
                         cfg.num_kv_heads * cfg.head_dim_)}
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = models.init_params(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    rec.update(init_s=time.perf_counter() - t0,
               params_gb=sum(t.numel() * t.element_size()
                             for t in leaves(params)) / 1e9)
    need[f"{short}_reference"] = (ssm_reference(params, cfg, device), attn)

    def reqs():
        return requests(cfg, seed=0, max_new=FAMILY_NEW)
    if max(len(r.prompt) for r in reqs()) > cfg.ssm_chunk:
        raise AssertionError(f"{name}: a prompt over the SSD chunk")

    def engine(graphs=True):
        return Engine(cfg, params, max_batch=8, max_len=512,
                      opts=models.ModelOpts(use_flash=True,
                                            use_flash_decode=True),
                      device=device, graphs=graphs)

    def serve(eng):
        with forbid_sdpa(), forbid_plain(), decode_rows(eng) as rows:
            res, c = counted(lambda: eng.serve(reqs()))
        check_results(f"{name} serve", res, cfg, FAMILY_NEW)
        steps = eng.stats["steps"]
        want = {"flash_attention": n_attn * len(res),
                "flash_decode": n_attn * steps}
        got = {k: c[k] for k in want}
        if got != want or sum(c.values()) != sum(want.values()):
            raise AssertionError(f"{name}: launches {c}, want {want}")
        return res, c, rows
    eng = engine()
    if eng.kv.layout != "contiguous" or eng.chunked:
        raise AssertionError(f"{name}: engine {eng.kv.layout}, chunked "
                             f"{eng.chunked}")
    res, c, rows_g = serve(eng)
    need[f"{short}_serve"] = (c, attn)
    rec.update(serve_stats=serve_record(eng),
               serve_launches={k: v for k, v in c.items() if v})
    twin = engine(graphs=False)
    res_e, c_e, rows_e = serve(twin)
    same_tokens(f"{name} graphed vs eager", res, res_e)
    if c_e != c:
        raise AssertionError(f"{name}: eager launches {c_e} against {c}")
    if len(rows_g) != len(rows_e) or not all(
            np.array_equal(pg, pe) and torch.equal(lg, le)
            for (pg, lg), (pe, le) in zip(rows_g, rows_e)):
        raise AssertionError(f"{name}: graphed and eager decode logits "
                             "differ")
    need[f"{short}_serve_eager"] = (c_e, attn)
    rec.update(serve_eager_stats=serve_record(twin),
               decode_rows_bitwise_equal=len(rows_g))
    del twin, rows_g, rows_e
    res, c, _ = serve(eng)
    need[f"{short}_serve_steady"] = (c, attn)
    rec["serve_steady_stats"] = serve_record(eng)
    if rec["serve_steady_stats"]["graphs_captured"]:
        raise AssertionError(f"{name}: the steady serve captured a graph")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    rec["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    rec["launches"] = {k[len(short) + 1:]: {n: v for n, v in c.items() if v}
                       for k, (c, _) in need.items()}
    emit(dict(rec, seconds_total=time.perf_counter() - t_start))
    return need


def whisper_phase(device, t_start):
    """whisper-base at full width and depth (6 + 6 layers), bf16, random
    weights on the card: ``prefill_fn`` of WHISPER_ROWS rows of 1500
    random frames and WHISPER_PROMPT prompt tokens, then WHISPER_STEPS
    greedy ``decode_fn`` steps eagerly, then the same steps replayed from
    one CUDA graph on a copy of the prefilled caches (logits bit for bit
    the eager steps'); the prefill and every decode logits row held to a
    train-mode decoder pass over the same tokens within LOGITS_TOL.
    Whisper runs no kernel (as the reference: its encoder attention is not
    causal and its cross-attention reads encoder K/V), so nothing may
    launch."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.kernels import _graphs
    from repro_torch.models import encdec
    from repro_torch.tree import leaves, map_tree
    cfg = get_config("whisper-base")
    b, p0, steps = WHISPER_ROWS, WHISPER_PROMPT, WHISPER_STEPS
    torch.cuda.reset_peak_memory_stats(device)
    params = models.init_params(cfg, seed=0, device=device)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    frames = torch.randn((b, cfg.encoder_seq_len, cfg.d_model),
                         generator=gen).to(device)
    prompt = torch.randint(0, cfg.vocab_size, (b, p0), generator=gen).to(
        device).int()
    caches = models.init_caches(cfg, b, cfg.max_seq_len, device=device)

    def eager():
        lg, cs = models.prefill_fn(params, cfg, {"frames": frames,
                                                 "tokens": prompt}, caches)
        cs0 = map_tree(lambda t: t.clone(), cs)
        torch.cuda.synchronize()
        toks, logits, ms = [lg.argmax(-1).int()], [], []
        for i in range(steps):
            pos = torch.full((b,), p0 + i, dtype=torch.int32, device=device)
            t1 = time.perf_counter()
            lg2, cs = models.decode_fn(params, cfg, toks[-1], pos, cs)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            logits.append(lg2.float())
            toks.append(lg2.argmax(-1).int())
        return lg.float(), toks, torch.stack(logits, 1), ms, cs0
    (lg_pre, toks, lg_dec, eager_ms, cs0), c = counted(eager)
    if any(c.values()):
        raise AssertionError(f"whisper: kernels launched {c}")

    # the same steps from one graph, on the prefilled caches' copy
    tok_s = toks[0].clone()
    pos_s = torch.full((b,), p0, dtype=torch.int32, device=device)
    stream = torch.cuda.Stream(device)
    step = lambda: models.decode_fn(params, cfg, tok_s, pos_s, cs0)[0]
    # the warm-up writes position p0 as the first step would, with the
    # same token, so the capture and every replay find the caches as the
    # eager steps did
    _graphs.on_stream(step, stream)
    graph = _graphs.capture(step, stream=stream,
                            pool=torch.cuda.graph_pool_handle())
    graph_ms, same = [], True
    for i in range(steps):
        tok_s.copy_(toks[i])
        pos_s.fill_(p0 + i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = graph.replay()
        torch.cuda.synchronize()
        graph_ms.append((time.perf_counter() - t1) * 1e3)
        same = same and torch.equal(out.float(), lg_dec[:, i])
    if not same:
        raise AssertionError("whisper: graphed decode logits differ from "
                             "the eager steps'")
    with torch.no_grad():
        seq = torch.cat([prompt] + [t[:, None] for t in toks[:-1]], dim=1)
        enc = encdec.encode(params, cfg, frames)
        pos = torch.arange(seq.shape[1], dtype=torch.int32,
                           device=device).expand(b, -1)
        full, _ = encdec._decoder(params, cfg, seq, pos, "train", None, enc,
                                  models.DEFAULT_OPTS)
    gate_logits("reference_logits_whisper_prefill_decode_vs_train",
                (lg_pre, lg_dec), (full[:, p0 - 1], full[:, p0:]),
                rows=b, frames=cfg.encoder_seq_len, steps=steps)
    rec = {"phase": "ssm_encdec", "arch": cfg.name,
           "layers": [cfg.encoder_layers, cfg.num_layers],
           "params_gb": sum(t.numel() * t.element_size()
                            for t in leaves(params)) / 1e9,
           # self K/V a token, and the cross K/V of the 1500 frames a slot
           "kv_bytes_per_token": cfg.num_layers * 2 * 2 * (
               cfg.num_kv_heads * cfg.head_dim_),
           "cross_kv_bytes_per_slot": cfg.num_layers * 2 * 2 * (
               cfg.encoder_seq_len * cfg.num_kv_heads * cfg.head_dim_),
           "decode_step_ms_eager": statistics.median(eager_ms),
           "decode_step_ms_graphed": statistics.median(graph_ms),
           "decode_logits_graphed_equal_eager": True,
           "launches": {n: v for n, v in c.items() if v}}
    del params, caches, cs0, graph, frames
    gc.collect()
    torch.cuda.empty_cache()
    rec["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    emit(dict(rec, seconds_total=time.perf_counter() - t_start))


def ssm_encdec_phase(device, t_start):
    """Phase 9c: mamba2-780m, zamba2-1.2b and whisper-base in turn, each's
    weights freed before the next."""
    need = {}
    for name in SSM_STACKS:
        need.update(ssm_stack_phase(name, device, t_start))
    whisper_phase(device, t_start)
    return need


# --------------------------------------------------------------------------- #
# phase 3 (after the search): Alg. 1 graphed and eager
# --------------------------------------------------------------------------- #

#: Monte-Carlo draws a layer of the sensitivity check (the search's own
#: profile takes 4)
SENS_ITERS = 8


def sensitivity_check(params, cfg, device, t_start):
    """Alg. 1 on full-width OLMoE on ``gmm`` through B1
    (``profile_sensitivity``, SENS_ITERS draws of 2 x 32 tokens a layer,
    the search's profile shape) with ``graphs`` at its default (a CUDA
    graph a MoE layer, captured in each call) and eagerly, in turns
    (graphed, eager, graphed): every table bit for bit the eager one, the
    launches equal; the seconds of each call.  Returns the launch
    needs."""
    from repro_torch.core import profile_sensitivity
    runs = []
    for graphs in (None, False, None):
        t0 = time.perf_counter()
        table, counts = counted(lambda: profile_sensitivity(
            params, cfg, n_iter=SENS_ITERS, batch=2, seq=32, seed=0,
            device=device, use_kernel=True, graphs=graphs))
        runs.append((graphs, time.perf_counter() - t0, table.values,
                     counts))
    want = runs[1][2]
    for graphs, _, values, counts in runs:
        if not np.array_equal(values, want) or counts != runs[1][3]:
            raise AssertionError(f"sensitivity graphs={graphs}: table "
                                 f"{values} against eager {want}; launches "
                                 f"{counts} against {runs[1][3]}")
    emit({"phase": "sensitivity", "layers": cfg.num_layers,
          "n_iter": SENS_ITERS, "tokens": 64,
          "target_topks": cfg.moe_top_k, "table_bits_equal": True,
          "graphed_s": [r[1] for r in runs if r[0] is None],
          "eager_s": runs[1][1], "launches": runs[1][3],
          "seconds_total": time.perf_counter() - t_start})
    return {"sensitivity": (runs[0][3], ("moe_gmm",)),
            "sensitivity_eager": (runs[1][3], ("moe_gmm",))}


# --------------------------------------------------------------------------- #
# phases 10-12: training and held-out evaluation
# --------------------------------------------------------------------------- #

#: the full-width trainer's depth: at OLMoE's 16 layers the train state
#: alone (bf16 params and grads, f32 AdamW moments: 12 B a parameter) is
#: 83 GB, more than the card's 80
TRAIN_LAYERS = 8
TRAIN_STEPS = 6
#: held-out log ppl through moe_ffn and flash_attention against the plain
#: paths' on the same trained weights (bf16 rounding of the kernels'
#: hidden and of P moves a token's log-likelihood by about 1e-3)
LOG_PPL_TOL = 1e-2
#: held-out batches of the train phase's evals (one eager, two replays)
EVAL_STEPS = 3


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gb(device):
    """Peak device memory since the last reset (None off the card)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


def _allocated_gb(device):
    """Device memory allocated now (None off the card)."""
    if device.type != "cuda":
        return None
    return torch.cuda.memory_allocated(device) / 1e9


def _timed(fn, device):
    """-> (fn's result, ms): CUDA events around it on the card, the host
    clock in a CPU rehearsal."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def graphed_against_eager(tag, fn, device, reps: int = 5) -> dict:
    """``fn()`` (a tensor) timed eagerly and as a CUDA graph replay
    (``reps`` each, in turns, CUDA events; the graph captured after an
    eager call on its stream): {tag_ms, tag_eager_ms} medians; every
    replay's output bit for bit the eager call's."""
    from repro_torch.kernels import _graphs
    stream = _graphs.side_stream(device)
    want = _graphs.on_stream(fn, stream).clone()
    graph = _graphs.capture(fn, stream=stream,
                            pool=torch.cuda.graph_pool_handle())
    graphed, eager = [], []
    for _ in range(reps):
        got, ms = _timed(graph.replay, device)
        graphed.append(ms)
        if not torch.equal(got, want):
            raise AssertionError(f"{tag}: a replay {got} against the eager "
                                 f"call's {want}")
        eager.append(_timed(fn, device)[1])
    return {f"{tag}_ms": statistics.median(graphed),
            f"{tag}_eager_ms": statistics.median(eager)}


def graphed_split_steps(state, grads_of, opt, b, device) -> dict:
    """Forward+backward and the optimizer of the train step, each as a
    CUDA graph on the batch ``b`` (one memory pool, each part run once
    eagerly on the capture stream first), timed over 3 replays each in
    turns; the optimizer's graph reads the step's scalars from a device
    tensor (``AdamW.scalars``) and updates the state in place."""
    from repro_torch.kernels import _graphs
    stream = _graphs.side_stream(device)
    pool = torch.cuda.graph_pool_handle()

    def fb():
        return grads_of(state.params, b)
    _graphs.on_stream(fb, stream)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    g_fb = _graphs.capture(fb, stream=stream, pool=pool)
    grads = g_fb.output[2]
    scalars = opt.scalars(state.opt.step + 1).to(device)

    def up():
        return opt.step_(grads, state.opt, state.params, scalars)
    _graphs.on_stream(up, stream)
    g_up = _graphs.capture(up, stream=stream, pool=pool)
    fb_ms, up_ms = [], []
    for _ in range(3):
        fb_ms.append(_timed(g_fb.replay, device)[1])
        up_ms.append(_timed(g_up.replay, device)[1])
    del g_fb, g_up, grads
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return {"graphed_fwd_bwd_ms": fb_ms, "graphed_optimizer_ms": up_ms,
            "graphed_fwd_bwd_ms_median": statistics.median(fb_ms),
            "graphed_optimizer_ms_median": statistics.median(up_ms)}


def _saved_gb(cfg, params, batch, opts, device):
    """Device GB a forward keeps for its backward: allocated after the loss
    less allocated before (None off the card)."""
    if device.type != "cuda":
        return None
    from repro_torch import models
    from repro_torch.tree import leaves, unflatten
    live = [p.detach().requires_grad_() for p in leaves(params)]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(device)
    with torch.enable_grad():
        loss, _ = models.loss_fn(unflatten(params, live), cfg, batch,
                                 opts=opts)
    torch.cuda.synchronize()
    saved = (torch.cuda.memory_allocated(device) - before) / 1e9
    del loss
    return saved


def train_distance(losses, params, ref_losses, ref_params) -> dict:
    """Two runs of the same steps apart: the largest loss difference, and
    the largest error of a param leaf over that leaf's largest entry."""
    if len(losses) != len(ref_losses) or len(params) != len(ref_params):
        raise AssertionError(f"runs of {len(losses)} and {len(ref_losses)} "
                             "steps")
    leaf = 0.0
    for a, b in zip(params, ref_params):
        leaf = max(leaf, ((a.float() - b.float()).abs().max()
                          / b.float().abs().max().clamp(min=1e-30)).item())
    return {"loss": max(abs(a - b) for a, b in zip(losses, ref_losses)),
            "leaf_rel": leaf}


def train_gate(dist, eager_eager=None) -> bool:
    """The gate a graphed train step is held to against the eager one:
    within WITNESS_RATIO of ``eager_eager``, the distance between two
    eager runs of the same steps (``train_phase`` measures it): bits where
    they are bitwise equal, and where it was not measured."""
    ee = eager_eager or {k: 0.0 for k in dist}
    return all(dist[k] <= WITNESS_RATIO * ee[k] for k in dist)


def train_phase(cfg, device, t_start, steps: int = TRAIN_STEPS,
                batch: int = 4, seq: int = 512):
    """``train`` on the plain paths (the config's own ``dense`` impl) for
    ``steps`` AdamW steps of ``batch`` x ``seq`` Zipf-Markov tokens, twice
    eagerly (``graphs=False``) and once with ``graphs`` at its default
    (the first step eager, the others replays of one CUDA graph): the
    graphed run held to the first eager one by ``train_gate``, whose
    distance the two eager runs set; each run's step ms and peak.  Then,
    on the trained state, forward+backward and the optimizer timed apart
    (3 more steps), eagerly and each as a CUDA graph; a train step with
    ``use_moe_kernel`` refused; held-out perplexity through ``moe_ffn``
    and ``flash_attention`` graphed bit for bit the eager one's, within
    LOG_PPL_TOL of the plain paths'; one eval batch timed graphed and
    eager; one step from the same init under ``remat="full"``: the first
    step's loss bit for bit, its forward+backward at a lower peak, and
    fewer activations kept by its forward for the backward than without
    (``dots`` read beside them).  Returns (the launch needs of the kernel
    eval, the two eager runs' distance)."""
    import gc
    import math
    from repro_torch import models
    from repro_torch.data import DataConfig, sample_batch, to_device
    from repro_torch.models import ModelOpts
    from repro_torch.optim import AdamW
    from repro_torch.training import eval_perplexity, init_state, \
        make_train_step, train, value_and_grad
    from repro_torch.tree import leaves
    dc = DataConfig(cfg.vocab_size, seq, batch, seed=0)
    opt = AdamW(total_steps=steps, warmup_steps=2)

    def run(graphs):
        base = (torch.cuda.memory_allocated(device)
                if device.type == "cuda" else 0)
        _reset_peak(device)
        t0 = time.perf_counter()
        res = train(cfg, dc, total_steps=steps, optimizer=opt, seed=0,
                    device=device, graphs=graphs)
        secs = time.perf_counter() - t0
        peak = _peak_gb(device)
        if not (np.isfinite(res.losses).all() and np.isfinite(
                res.grad_norms).all() and len(res.losses) == steps):
            raise AssertionError(f"train: losses {res.losses}, grad norms "
                                 f"{res.grad_norms}")
        return res, secs, None if peak is None else peak - base / 1e9

    # two eager runs (the first one's params kept), then the graphed one
    eager, eager_s, eager_peak = run(False)
    eager_params = leaves(eager.state.params)
    eager_rec = {"losses": eager.losses,
                 "step_ms": [t * 1e3 for t in eager.step_times]}
    del eager
    again, _, _ = run(False)
    ee = train_distance(again.losses, leaves(again.state.params),
                        eager_rec["losses"], eager_params)
    del again
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    res, train_s, peak = run(None)
    ge = train_distance(res.losses, leaves(res.state.params),
                        eager_rec["losses"], eager_params)
    del eager_params
    replays = steps - 1 if device.type == "cuda" else 0
    if res.graph_replays != replays or not train_gate(ge, ee):
        raise AssertionError(f"train graphed: {res.graph_replays} replays, "
                             f"distance {ge} to eager against {ee} x "
                             f"{WITNESS_RATIO}")
    n_params = sum(p.numel() for p in leaves(res.state.params))
    state = res.state
    step_ms = [t * 1e3 for t in res.step_times]
    first_loss = res.losses[0]
    rec = {"phase": "train", "layers": cfg.num_layers,
           "d_model": cfg.d_model, "experts": cfg.num_experts,
           "top_k": cfg.moe_top_k, "impl": cfg.moe_impl, "dtype": cfg.dtype,
           "batch": [batch, seq], "params_b": n_params / 1e9,
           "steps": [{"loss": l, "grad_norm": g, "wall_ms": t}
                     for l, g, t in zip(res.losses, res.grad_norms,
                                        step_ms)],
           "train_s": train_s, "graph_replays": res.graph_replays,
           "eager_steps_wall_ms": eager_rec["step_ms"],
           "eager_train_s": eager_s,
           "eager_step_ms_median": statistics.median(
               eager_rec["step_ms"][1:]),
           "gate": {"graphed_vs_eager": ge, "eager_vs_eager": ee,
                    "ratio": WITNESS_RATIO},
           "data_s_per_batch": res.data_s_per_batch}
    del res

    # the step in two parts, each timed on the device, on the trained
    # state: eagerly, then each part as a CUDA graph
    grads_of = value_and_grad(cfg)

    def split_step(state, i):
        b = to_device(sample_batch(dc, i), device)
        rec["fwd_bwd_base_gb"] = _allocated_gb(device)
        _reset_peak(device)
        (_, _, grads), fb = _timed(lambda: grads_of(state.params, b), device)
        peak_fb = _peak_gb(device)
        new_opt, om = _timed(lambda: opt.step_(grads, state.opt,
                                               state.params), device)
        return state._replace(opt=new_opt), b, fb, om, peak_fb

    fb_ms, opt_ms = [], []
    for i in range(3):
        state, b, fb, om, peak_fb = split_step(state, steps + i)
        fb_ms.append(fb)
        opt_ms.append(om)
    med_step = statistics.median(step_ms[1:])
    rec.update(step_ms_median=med_step,
               fwd_bwd_ms_median=statistics.median(fb_ms),
               optimizer_ms_median=statistics.median(opt_ms),
               fwd_bwd_ms=fb_ms, optimizer_ms=opt_ms,
               tokens_per_s=batch * seq / (med_step / 1e3),
               data_s_per_step_s=rec["data_s_per_batch"] / (med_step / 1e3),
               peak_gb=peak, eager_peak_gb=eager_peak,
               fwd_bwd_peak_gb=peak_fb, state_gb_12b=12 * n_params / 1e9)
    if device.type == "cuda":
        rec.update(graphed_split_steps(state, grads_of, opt, b, device))

    # no kernel under autograd
    try:
        make_train_step(cfg, opt, opts=ModelOpts(use_moe_kernel=True))(
            state, b)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        rec["guard"] = str(e).split(":")[0]
    else:
        raise AssertionError("train: a step with use_moe_kernel ran")

    # held-out perplexity through the kernels, graphed (the default: the
    # first batch eager, the later ones replays) and eagerly, against the
    # plain paths
    kern = ModelOpts(use_flash=True, use_moe_kernel=True)
    ppl_k, counts = counted(lambda: eval_perplexity(
        state.params, cfg, dc, steps=EVAL_STEPS, opts=kern))
    ppl_e, counts_e = counted(lambda: eval_perplexity(
        state.params, cfg, dc, steps=EVAL_STEPS, opts=kern, graphs=False))
    if ppl_k != ppl_e or counts != counts_e:
        raise AssertionError(f"train eval: graphed ppl {ppl_k!r} against "
                             f"eager {ppl_e!r}; launches {counts} against "
                             f"{counts_e}")
    ppl_p = eval_perplexity(state.params, cfg, dc, steps=EVAL_STEPS)
    dlog = abs(math.log(ppl_k) - math.log(ppl_p))
    if not dlog <= LOG_PPL_TOL:
        raise AssertionError(f"train eval: ppl {ppl_k} through the kernels "
                             f"against {ppl_p} plain")
    rec.update(eval_ppl_kernels=ppl_k, eval_ppl_kernels_eager=ppl_e,
               eval_ppl_graphed_equal_eager=True, eval_ppl_plain=ppl_p,
               eval_log_ppl_diff=dlog, eval_launches=counts)
    if device.type == "cuda":
        eb = to_device(sample_batch(dc, 10_000), device)
        with torch.no_grad():
            rec.update(graphed_against_eager(
                "eval_batch", lambda: models.loss_fn(
                    state.params, cfg, eb, opts=kern)[1]["xent"], device))
        del eb
    del state, b
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the first step again from the same init, under remat="full": the
    # forward+backward's peak (the step's own peak is the optimizer's, on
    # top of the whole train state, and remat does not move it)
    st = init_state(cfg, opt, 0, device=device)
    b = to_device(sample_batch(dc, 0), device)
    saved = {r: _saved_gb(cfg, st.params, b, ModelOpts(remat=r), device)
             for r in ("none", "full", "dots")}
    rec["remat_full_base_gb"] = _allocated_gb(device)
    _reset_peak(device)
    loss, _, grads = value_and_grad(cfg, opts=ModelOpts(remat="full"))(
        st.params, b)
    peak_full = _peak_gb(device)
    opt.step_(grads, st.opt, st.params)
    loss_full = float(loss)
    del st, b, grads
    if loss_full != first_loss:
        raise AssertionError(f"train remat=full: loss {loss_full!r} against "
                             f"{first_loss!r}")
    if peak_fb is not None and not (peak_full < peak_fb
                                    and saved["full"] < saved["none"]):
        raise AssertionError(f"train remat=full: forward+backward peak "
                             f"{peak_full} GB against {peak_fb} GB; saved "
                             f"activations {saved}")
    rec.update(remat_full_loss_equal=True,
               remat_full_fwd_bwd_peak_gb=peak_full, saved_gb=saved,
               seconds_total=time.perf_counter() - t_start)
    emit(rec)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"train_eval": (counts, ("moe_ffn", "flash_attention"))}, ee


QUALITY_STEPS = 200


def train_quality_phase(device, t_start, steps: int = QUALITY_STEPS,
                        requests: int = 12):
    """``launch/serve_lexi.py``'s recipe on the card: the tiny OLMoE-family
    model (f32) trained ``steps`` steps; Alg. 1 (n_iter 8, 2 x 32) through
    B1 and on the plain paths, the tables within RECIPE_TOL (largest
    difference over the largest value) and each one's DP plan at a 50 %
    budget printed, equal or not; held-out ppl (6 eval batches) of the
    untrained model, the baseline, the kernel table's LExI plan,
    ``inter_prune(0.25)`` and ``intra_prune(0.25)``, all on the dropless
    ``gmm`` through B1 and B2, the baseline's within RECIPE_TOL relative
    of the plain paths'; the trained baseline must be below 0.8x the
    untrained ppl.  Then the baseline and the plan served through one
    graphed engine on the kernels (12 requests of 16 prompt and 16 new
    tokens, a warm-up wave first).  Returns the launch needs."""
    from repro_torch import models
    from repro_torch.core import apply_plan_params, inter_prune, \
        intra_prune, optimize, profile_sensitivity
    from repro_torch.launch.serve_lexi import trained_tiny_moe
    from repro_torch.models import ModelOpts
    from repro_torch.serving import Engine, Request
    from repro_torch.training import eval_perplexity
    t0 = time.perf_counter()
    cfg, params, dc, res = trained_tiny_moe(steps, device=device)
    train_s = time.perf_counter() - t0
    gmm = cfg.with_(moe_impl="gmm")
    opts = ModelOpts(moe_impl="gmm", use_flash=True, use_moe_kernel=True)

    def ppl(p, c, o=opts):
        return eval_perplexity(p, c, dc, steps=6, opts=o)

    untrained = ppl(models.init_params(cfg, 0, device=device), gmm)
    budget = gmm.num_moe_layers * gmm.moe_top_k // 2
    tables, need = {}, {}
    for name, kern in (("kernel", True), ("plain", False)):
        tables[name], counts = counted(lambda: profile_sensitivity(
            params, gmm, n_iter=8, batch=2, seq=32, seed=0, device=device,
            use_kernel=kern))
        if kern:
            need["recipe_profile"] = (counts, ("moe_gmm",))
        elif any(counts.values()):
            raise AssertionError(f"train_quality: plain Alg. 1 launched "
                                 f"{counts}")
    want = tables["plain"].values
    table_rel = float(np.abs(tables["kernel"].values - want).max()
                      / np.abs(want).max())
    plan = optimize(params, gmm, budget, method="dp",
                    table=tables["kernel"])
    plain_plan = optimize(params, gmm, budget, method="dp",
                          table=tables["plain"])
    cfg_l, params_l = apply_plan_params(params, gmm, plan)
    base, counts = counted(lambda: ppl(params, gmm))
    need["recipe_eval"] = (counts, ("moe_gmm", "flash_attention"))
    rows = {"baseline": base, "lexi": ppl(params_l, cfg_l)}
    for name, prune in (("inter_prune_0.25", inter_prune),
                        ("intra_prune_0.25", intra_prune)):
        rows[name] = ppl(*prune(params, gmm, 0.25))
    plain_base = ppl(params, gmm, ModelOpts(moe_impl="gmm"))
    ppl_rel = abs(base - plain_base) / plain_base
    if not all(np.isfinite(v) for v in rows.values()):
        raise AssertionError(f"train_quality: ppl {rows}")
    if not rows["baseline"] < 0.8 * untrained:
        raise AssertionError(f"train_quality: trained ppl "
                             f"{rows['baseline']} against untrained "
                             f"{untrained}")
    if table_rel > RECIPE_TOL or ppl_rel > RECIPE_TOL:
        raise AssertionError(f"train_quality: Alg. 1's table {table_rel}, "
                             f"ppl {base} against plain {plain_base} "
                             f"({ppl_rel}) past {RECIPE_TOL}")

    def reqs():
        return [Request(uid=i, prompt=np.random.default_rng(i).integers(
            0, cfg.vocab_size, 16).astype(np.int32), max_new_tokens=16)
            for i in range(requests)]

    eng = Engine(gmm, params, max_batch=4, max_len=128, prefill_pad=16,
                 use_kernel=True, use_moe_decode=True,
                 opts=ModelOpts(use_moe_kernel=True), device=device)
    eng.add_plan("lexi", plan)
    tok_s = {}
    for name in ("base", "lexi"):
        eng.serve(reqs(), plan=name)               # captures its keys
        res_q, counts = counted(lambda: eng.serve(reqs(), plan=name))
        check_results(f"train_quality {name}", res_q, gmm, 16)
        need[f"recipe_serve_{name}"] = (
            counts, ("moe_gmm", "moe_decode", "flash_decode_paged"))
        tok_s[name] = eng.throughput()
    emit({"phase": "train_quality", "config": {
              "layers": cfg.num_layers, "d_model": cfg.d_model,
              "experts": cfg.num_experts, "top_k": cfg.moe_top_k,
              "moe_d_ff": cfg.moe_d_ff, "vocab": cfg.vocab_size,
              "dtype": cfg.dtype, "batch": [dc.global_batch, dc.seq_len]},
          "steps": steps, "train_s": train_s,
          "train_step_ms_median": statistics.median(res.step_times[1:]) * 1e3,
          "final_loss": res.losses[-1], "plan": list(plan.plan),
          "plain_plan": list(plain_plan.plan),
          "plans_equal": plan.plan == plain_plan.plan,
          "table_rel_to_plain": table_rel, "ppl_plain_baseline": plain_base,
          "ppl_rel_to_plain": ppl_rel, "tol": RECIPE_TOL,
          "budget": budget, "ppl_untrained": untrained, "ppl": rows,
          "serve_tok_s": tok_s,
          "seconds_total": time.perf_counter() - t_start})
    del eng, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return need


# --------------------------------------------------------------------------- #
# phase 13: expert parallelism on a one-card mesh
# --------------------------------------------------------------------------- #

#: the mesh phase's train step against the no-mesh step: one rank sums
#: nothing across ranks, so the same buffers reach the same plain ops and
#: equal bits are expected; a leaf passes within one bf16 step of its
#: largest entry, the loss within 1e-5 of itself
MESH_LEAF_TOL = 2.0 ** -8
MESH_LOSS_TOL = 1e-5
#: decode steps of the context-parallel check, and its prompt length
MESH_DECODE_STEPS = 8
MESH_PROMPT = 256
#: the mesh train step's steps, eager and graphed
MESH_TRAIN_STEPS = 3


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi: {smi.stderr.strip()}")


def mesh_checks(mesh, device, rows, plan, rec):
    """B9 at the mesh path's new shape, then checks (a)-(c) of
    ``mesh_phase`` on full-depth OLMoE with the plain versions forbidden;
    returns the launch needs."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.sharding import local_params
    cfg = get_config("olmoe-1b-7b")
    params = models.init_params(cfg, seed=0, device=device)
    lp = local_params(params, cfg, mesh, fsdp=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    batch = models.make_train_batch(cfg, gen, 4, 512, device=device)
    need = {}

    # B9 at the new shape, against its plain version before the plain
    # versions are forbidden: the first of two a2a chunks of 2048 tokens'
    # buffers (also ep_psum's prefill of 4 x 256 prompts)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    x = torch.randn((2048, cfg.d_model), generator=gen, device=device,
                    dtype=torch.bfloat16)
    b9 = kernel_row("moe_ffn", "", "", *check_moe_ffn(
        params["layers"][0]["moe"], cfg, x, flush, "olmoe_ep_c160", 2))
    rows["moe_ffn"]["shapes"]["olmoe_ep_c160"] = {
        k: b9[k] for k in NESTED_KEYS if k in b9}
    rows["moe_ffn"]["max_abs_err"] = max(rows["moe_ffn"]["max_abs_err"],
                                         b9["max_abs_err"])
    del flush, x
    with forbid_plain(), torch.no_grad():
        need.update(mesh_paths(mesh, device, cfg, params, lp, batch, plan,
                               rec))
        need.update(mesh_serve_check(mesh, device, cfg, params, lp, rec))
    return need


def mesh_paths(mesh, device, cfg, params, lp, batch, plan, rec):
    """(a) of ``mesh_phase``; returns the launch needs.  Every input is
    the rank's data block (``ep_a2a`` keeps its ``1 / model`` of the rows
    itself)."""
    from repro_torch import models
    from repro_torch.analysis import record
    from repro_torch.models import ModelOpts
    from repro_torch.sharding import Sharding, comm, local_cache_specs, \
        local_tree, named
    data = Sharding(mesh, ("data",))
    mine = {k: data.local(v) for k, v in batch.items()}
    need = {}

    def forward(c, p, opts, m, b):
        """loss_fn and whole-prompt prefill logits on ``b``."""
        loss, met = models.loss_fn(p, c, b, mesh=m, opts=opts)
        caches = models.init_caches(c, b["tokens"].shape[0], 512,
                                    layout="contiguous", device=device)
        logits, _ = models.prefill_fn(p, c, {"tokens": b["tokens"]}, caches,
                                      mesh=m, opts=opts)
        del caches
        return (torch.stack([loss, met["xent"], met["aux"]]),
                comm.all_gather(logits, mesh, "data")
                if m is not None else logits)

    # (a) + (b): ep_a2a at a2a_chunks 1 and 2, and under the plan, against
    # dense; B9 both sides
    cfg_plan = cfg.with_lexi_plan(plan.plan)
    dense_opts = ModelOpts(use_flash=True, use_moe_kernel=True)
    a2a = {}
    for tag, c in (("base", cfg), ("plan", cfg_plan)):
        (want, want_logits), counts = counted(lambda: forward(
            c, params, dense_opts, None, batch))
        need[f"mesh_dense_{tag}"] = (counts, ("moe_ffn",))
        ref_dig = digest(want_logits)
        for chunks in ((1, 2) if tag == "base" else (1,)):
            opts = ModelOpts(use_flash=True, use_moe_kernel=True,
                             moe_impl="ep_a2a", a2a_chunks=chunks,
                             fsdp_params=True)
            with record() as stats:
                (got, got_logits), counts = counted(lambda: forward(
                    c, lp, opts, mesh, mine))
            key = f"ep_a2a_{tag}_c{chunks}"
            need[f"mesh_{key}"] = (counts, ("moe_ffn", "flash_attention"))
            compare_rows(f"mesh_{key}_prefill_logits", got_logits,
                         want_logits)
            loss_err = float((got - want).abs().max() / want.abs().max())
            dig = digest(got_logits)
            if dig != ref_dig or not torch.equal(got, want):
                raise AssertionError(f"mesh {key}: loss, xent, aux {got} "
                                     f"against dense {want}, logits digest "
                                     f"{dig} against {ref_dig}")
            # two passes (loss_fn and prefill), each an a2a there and back
            # a MoE layer and chunk
            a2a[key] = stats.bytes_by_kind["all-to-all"] // 2
            rec[key] = {"loss_xent_aux": got.tolist(),
                        "dense": want.tolist(), "loss_rel_err": loss_err,
                        "digest": dig, "dense_digest": ref_dig,
                        "bits_equal": dig == ref_dig,
                        "loss_bits_equal": bool(torch.equal(got, want)),
                        "a2a_bytes_a_forward": a2a[key],
                        "a2a_calls": stats.count_by_kind["all-to-all"],
                        "b9_launches": counts["moe_ffn"]}
    if not a2a["ep_a2a_plan_c1"] < a2a["ep_a2a_base_c1"]:
        raise AssertionError(f"mesh: a2a bytes under the plan {a2a}")
    rec["plan"] = list(plan.plan)
    rec["a2a_bytes_plan_over_base"] = (a2a["ep_a2a_plan_c1"]
                                       / a2a["ep_a2a_base_c1"])

    # (c) prefill and decode through ep_psum with the cache rows' sequence
    # dim sharded over `model`, against the same steps with no mesh
    prompt = batch["tokens"][:, :MESH_PROMPT]
    b = prompt.shape[0]
    plain = ModelOpts(use_flash=True, use_moe_kernel=True, moe_impl="ep_psum")
    ctx = ModelOpts(use_flash=True, use_moe_kernel=True, moe_impl="ep_psum",
                    decode_kv_seq_shard=True, fsdp_params=True)

    def decode_run():
        caches = models.init_caches(cfg, b, 512, layout="contiguous",
                                    device=device)
        shard = named(mesh, local_cache_specs(caches, cfg, mesh,
                                              seq_shard=True))
        ours = local_tree(models.init_caches(cfg, b, 512,
                                             layout="contiguous",
                                             device=device), shard)
        l0, caches = models.prefill_fn(params, cfg, {"tokens": prompt},
                                       caches, opts=plain)
        l1, ours = models.prefill_fn(lp, cfg, {"tokens": data.local(prompt)},
                                     ours, mesh=mesh, opts=ctx)
        steps = [(l0, comm.all_gather(l1, mesh, "data"))]
        tok = l0.argmax(-1).int()
        pos = torch.full((b,), MESH_PROMPT, dtype=torch.int32, device=device)
        for _ in range(MESH_DECODE_STEPS):
            l0, caches = models.decode_fn(params, cfg, tok, pos, caches,
                                          opts=plain)
            l1, ours = models.decode_fn(lp, cfg, data.local(tok),
                                        data.local(pos), ours, mesh=mesh,
                                        opts=ctx)
            steps.append((l0, comm.all_gather(l1, mesh, "data")))
            tok, pos = l0.argmax(-1).int(), pos + 1
        return steps

    steps, counts = counted(decode_run)
    need["mesh_ep_psum_seq_shard"] = (counts, ("moe_ffn",))
    greedy = []
    for i, (want, got) in enumerate(steps):
        compare_rows(f"mesh_ctx_decode_step{i}", got, want)
        greedy.append(bool(torch.equal(got.argmax(-1), want.argmax(-1))))
        if not torch.equal(got, want):
            raise AssertionError(f"mesh ctx decode: step {i}'s logits are "
                                 "not the no-mesh step's bits")
    rec["ctx_decode"] = {"prompt": [b, MESH_PROMPT],
                         "decode_steps": MESH_DECODE_STEPS,
                         "greedy_equal": greedy,
                         "max_row_rel_err": max(
                             row_rel_err(g, w).max().item()
                             for w, g in steps),
                         "b9_launches": counts["moe_ffn"]}
    return need


def mesh_train_check(mesh, device, rec, eager_eager=None):
    """(b) train steps of a depth-4, full-width OLMoE under the mesh with
    ``fsdp_params``, ZeRO-1 and ``remat_chunk`` 2 (its 4 layers in two
    checkpointed chunks): the first against the no-mesh step with
    per-layer remat on the same batch (plain paths: no kernel has a
    backward), the loss and every leaf of the state bit for bit; then
    MESH_TRAIN_STEPS steps eagerly and again as a CUDA graph
    (``make_train_step(graphs=True)``: the first step eager, the later
    ones replays, the NCCL collectives inside), held to each other by
    ``train_gate`` on ``eager_eager`` (``train_phase``'s) and their
    collectives equal."""
    from repro_torch import models
    from repro_torch.analysis import record
    from repro_torch.configs import get_config
    from repro_torch.models import ModelOpts
    from repro_torch.optim import AdamW
    from repro_torch.sharding import Sharding, local_tree
    from repro_torch.training import init_state, make_train_step, \
        whole_shardings
    from repro_torch.tree import leaves
    cfg = get_config("olmoe-1b-7b").with_(num_layers=4)
    opt = AdamW(total_steps=4, warmup_steps=1)
    gen = torch.Generator(device=device)
    gen.manual_seed(6)
    batch = models.make_train_batch(cfg, gen, 4, 512, device=device)
    want, m0 = make_train_step(cfg, opt, opts=ModelOpts(remat="full"))(
        init_state(cfg, opt, 0, device=device), batch)
    opts = ModelOpts(remat="full", remat_chunk=2, fsdp_params=True)
    shardings = whole_shardings(cfg, mesh, opts)
    state = local_tree(init_state(cfg, opt, 0, device=device), shardings)
    data = Sharding(mesh, ("data",))
    batches = [{k: data.local(v) for k, v in b.items()} for b in
               [batch] + [models.make_train_batch(cfg, gen, 4, 512,
                                                  device=device)
                          for _ in range(MESH_TRAIN_STEPS - 1)]]
    step = make_train_step(cfg, opt, mesh=mesh, opts=opts)
    with record() as coll_eager:
        (got, m1), ms = _timed(lambda: step(state, batches[0]), device)
    want = local_tree(want, shardings)         # the rank's block of each
    loss0, loss1 = float(m0["loss"]), float(m1["loss"])
    worst, equal, n = 0.0, 0, 0
    for a, w in zip(leaves(got), leaves(want)):
        if not isinstance(a, torch.Tensor):
            continue
        n += 1
        equal += bool(torch.equal(a, w))
        err = ((a.float() - w.float()).abs().max()
               / w.float().abs().max().clamp(min=1e-30)).item()
        worst = max(worst, err)
    rec["train_step"] = {"layers": cfg.num_layers, "batch": [4, 512],
                         "remat_chunk": 2, "fsdp_params": True,
                         "loss": loss1, "no_mesh_loss": loss0,
                         "grad_norm": float(m1["grad_norm"]),
                         "no_mesh_grad_norm": float(m0["grad_norm"]),
                         "leaves": n, "leaves_bits_equal": equal,
                         "max_leaf_rel_err": worst, "step_ms": ms}
    if loss1 != loss0 or equal != n:
        raise AssertionError(f"mesh train: loss {loss1} against {loss0}, "
                             f"{equal} of {n} leaves bitwise equal (worst "
                             f"{worst})")
    del want

    def run(step, state, first, coll):
        losses, times = [first], []
        with record() as stats:
            for b in batches[1:]:
                (state, m), t = _timed(lambda: step(state, b), device)
                losses.append(float(m["loss"]))
                times.append(t)
        for k, c in stats.count_by_kind.items():
            coll[k] = coll.get(k, 0) + c
        return state, losses, times

    coll_eager = dict(coll_eager.count_by_kind)
    got, eager_losses, eager_ms = run(step, got, loss1, coll_eager)
    eager_params = leaves(got.params)
    del got, state
    gc.collect()
    torch.cuda.empty_cache()
    graphed = make_train_step(cfg, opt, mesh=mesh, opts=opts, graphs=True)
    state = local_tree(init_state(cfg, opt, 0, device=device), shardings)
    with record() as coll_graphed:
        state, m = graphed(state, batches[0])
    coll_graphed = dict(coll_graphed.count_by_kind)
    state, graphed_losses, graphed_ms = run(graphed, state, float(m["loss"]),
                                            coll_graphed)
    dist = train_distance(graphed_losses, leaves(state.params),
                          eager_losses, eager_params)
    rec["train_graphed"] = {
        "steps": MESH_TRAIN_STEPS, "replays": graphed.stats["replays"],
        "losses": graphed_losses, "eager_losses": eager_losses,
        "step_ms": graphed_ms, "eager_step_ms": eager_ms,
        "collectives": coll_graphed, "eager_collectives": coll_eager,
        "distance": dist, "eager_eager": eager_eager}
    replays = MESH_TRAIN_STEPS - 1 if device.type == "cuda" else 0
    if graphed.stats["replays"] != replays or \
            coll_graphed != coll_eager or not train_gate(dist, eager_eager):
        raise AssertionError(f"mesh train graphed: {rec['train_graphed']}")
    del state, graphed, eager_params


#: the mesh engine's workload: the 8 requests, fewer new tokens (the
#: eager oracles serve them too), in two waves
MESH_NEW = 16


def mesh_serve_check(mesh, device, cfg, params, lp, rec):
    """(c) ``Engine(mesh=)`` on the rank's blocks serving the 8 requests
    paged in two waves, with ``graphs`` at its default (CUDA graphs, their
    NCCL collectives inside: the first wave captures every key, the
    second replays) and with ``graphs=False`` (eager), against the
    no-mesh eager engine on the whole params, each engine through the
    same two waves (a pad query attends the stale bytes of its row's
    recycled pages, so its routing, and the capacity slots it takes,
    follow the pool's past): each wave's greedy tokens equal on the three
    engines, more than 0 graphs captured, each graphed wave's collectives
    (``record()``) and launches the eager wave's; every mesh serve
    launches B4 in decode and B9 in its ``ep_a2a`` chunks and ``ep_psum``
    decode steps.  Returns the launch needs."""
    from repro_torch import models
    from repro_torch.analysis import record
    from repro_torch.serving import Engine
    opts = models.ModelOpts(use_moe_kernel=True, fsdp_params=True)

    def waves(p, **kw):
        eng = Engine(cfg, p, max_batch=8, max_len=512, prefill_chunk=64,
                     use_kernel=True, opts=opts, device=device, **kw)
        out = []
        for _ in range(2):
            with record() as stats:
                res, counts = counted(lambda: eng.serve(
                    requests(cfg, seed=0, max_new=MESH_NEW)))
            out.append((res, counts, serve_record(eng),
                        {k: (stats.count_by_kind[k], stats.bytes_by_kind[k])
                         for k in sorted(stats.count_by_kind)}))
        return out

    no_mesh = waves(params, graphs=False)
    eager = waves(lp, mesh=mesh, graphs=False)
    graphed = waves(lp, mesh=mesh)
    (_, _, warm_stats, _), (got, c1, stats, coll) = graphed
    if stats["eager"] or device.type == "cuda" and (
            not warm_stats["graphs_captured"] or stats["graphs_captured"]
            or not stats["graph_replays"]):
        raise AssertionError(f"mesh engine: graphs at their default did not "
                             f"capture and replay on the mesh (first wave "
                             f"{warm_stats}, second {stats})")
    for w in range(2):
        want = no_mesh[w][0]
        for tag, runs in (("eager", eager), ("graphed", graphed)):
            check_results(f"mesh engine {tag} wave {w}", runs[w][0], cfg,
                          MESH_NEW)
            same_tokens(f"mesh engine {tag} wave {w} vs no mesh",
                        runs[w][0], want)
        if graphed[w][3] != eager[w][3] or graphed[w][1] != eager[w][1]:
            raise AssertionError(
                f"mesh engine wave {w}: graphed collectives {graphed[w][3]}"
                f", launches {graphed[w][1]} against the eager wave's "
                f"{eager[w][3]}, {eager[w][1]}")
    rec["engine"] = {"requests": len(got), "max_new": MESH_NEW, "waves": 2,
                     "tokens_equal": True, "launches": c1,
                     "no_mesh_launches": no_mesh[1][1], "collectives": coll,
                     "collectives_equal_eager": True,
                     "first_wave_stats": warm_stats,
                     "eager_stats": eager[1][2], **stats}
    return {"mesh_engine": (c1, ("moe_ffn", "flash_decode_paged")),
            "mesh_engine_eager": (eager[1][1],
                                  ("moe_ffn", "flash_decode_paged"))}


#: (e) DeepSeek-V2-Lite's depth in the MLA check under
#: ``decode_kv_seq_shard``, its rows and their prompt tokens
MLA_MESH = (4, 8, 64)


def mesh_mla_check(mesh, device, rec):
    """(e) C9: an MLA model decodes under ``decode_kv_seq_shard`` on the
    mesh as the reference does, every rank attending the whole latent
    cache (the flag shards GQA caches only): DeepSeek-V2-Lite at full
    width cut to MLA_MESH's layers, its rows' prompts prefilled in one
    chunk into a paged pool and one decode step, B7 in the decode
    (``use_paged_kernel``) and B9 in ``ep_a2a`` / ``ep_psum``, against the
    same steps with no mesh (``dense``, B9): bit for bit.  Returns the
    launch needs."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.sharding import Sharding, comm, local_params
    layers, b, c = MLA_MESH
    cfg = get_config("deepseek-v2-lite").with_(num_layers=layers)
    params = models.init_params(cfg, seed=0, device=device)
    lp = local_params(params, cfg, mesh)
    dev = ref_inputs(cfg, device, b=b, c=c)
    data = Sharding(mesh, ("data",))
    plain = models.ModelOpts(use_moe_kernel=True, use_paged_kernel=True,
                             moe_impl="ep_a2a")
    ctx = replace(plain, decode_kv_seq_shard=True)

    def run(p, opts, m):
        rows = {k: data.local(v) if m is not None else v
                for k, v in dev.items()}
        caches = models.init_caches(cfg, layout="paged", page_size=16,
                                    num_pages=b * 8 + 1, device=device)
        lg1, caches = models.chunk_prefill_fn(
            p, cfg, rows["tokens"], rows["positions"], caches,
            block_tables=rows["bt"], opts=opts, mesh=m)
        lg2, _ = models.decode_fn(p, cfg, rows["nxt"], rows["pos_c"], caches,
                                  block_tables=rows["bt"], opts=opts,
                                  kernel_blocks=8, mesh=m)
        return [lg if m is None else comm.all_gather(lg, mesh, "data")
                for lg in (lg1, lg2)]

    want, c0 = counted(lambda: run(params, plain, None))
    got, c1 = counted(lambda: run(lp, ctx, mesh))
    for i, (g, w) in enumerate(zip(got, want)):
        compare_rows(f"mesh_mla_seq_shard_step{i}", g, w)
        if not torch.equal(g, w):
            raise AssertionError(f"mesh MLA decode_kv_seq_shard: step {i}'s "
                                 "logits are not the no-mesh step's bits")
    if c1["flash_decode_paged_mla"] != layers or any(
            c1[n] for n in GQA_ATTENTION):
        raise AssertionError(f"mesh MLA decode_kv_seq_shard launched {c1}")
    rec["mla_seq_shard"] = {
        "layers": layers, "rows": b, "prompt": c, "layout": "paged",
        "kernels": ["flash_decode_paged_mla", "moe_ffn"],
        "bits_equal": True, "digest": digest(got[1]),
        "launches": c1, "no_mesh_launches": c0}
    return {"mesh_mla_seq_shard": (c1, ("flash_decode_paged_mla",
                                        "moe_ffn"))}


# --------------------------------------------------------------------------- #
# (d): the kernels at a rank's shapes of a 16-way model axis
# --------------------------------------------------------------------------- #

#: the model axis of the production (16, 16) mesh
TP_RANKS = 16
#: the ep_a2a rows a rank routes: a 4 x 512 data block over 16 ranks
TP_ROWS = 4 * 512 // TP_RANKS
TP_SHORT = {"olmo-1b": "olmo", "qwen3-32b": "qwen3_32b",
            "h2o-danube-1.8b": "danube", "llama4-scout-17b-a16e": "llama4",
            "qwen3-moe-235b-a22b": "qwen3_moe", "pixtral-12b": "pixtral",
            "zamba2-1.2b": "zamba2", "minicpm3-4b": "minicpm3"}


def tp_attention_shapes():
    """Rank 0's GQA attention at ``model`` = TP_RANKS in each assigned
    config that has one (whisper runs no tensor parallelism; mamba2 no
    attention): short -> (q heads, the cache's kv heads, the kv heads it
    attends -- a head slice of the cache where fewer --, hd, window), from
    the model's own plan (``attention._gqa_plan``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.attention import _gqa_plan
    from repro_torch.models.tp import TP
    tp = TP(None, m=TP_RANKS, r=0)
    out = {}
    for name, short in TP_SHORT.items():
        cfg = get_config(name)
        if cfg.attention != "gqa":
            continue
        plan = _gqa_plan(cfg, tp, False)
        qlo, qhi, klo, khi, a, b = plan or (0, cfg.num_heads, 0,
                                            cfg.num_kv_heads, 0,
                                            cfg.num_kv_heads)
        out[short] = (qhi - qlo, khi - klo, (a, b), cfg.head_dim_,
                      cfg.sliding_window)
    return out


def tp_kernel_checks(device, rows):
    """(d) B2, B4, B7, B8 and B9 at rank 0's shapes of a TP_RANKS-way
    ``model`` axis (``tp_attention_shapes``; MiniCPM3's 3 of 40 and
    DeepSeek-V2-Lite's 1 of 16 MLA heads, the heads over its rows of
    ``wo``; qwen3-moe's and llama4-scout's expert slice at an ``ep_a2a``
    buffer of TP_ROWS rows a rank), each against its plain version to
    ROW_TOL, the decode kernels' rows bitwise alone against the batch,
    timed beside the bound (as the phase-2 checks reckon it); each a sub-entry ``tp16_<config>`` of its
    kernel's ``shapes``.  Returns the numbers by kernel."""
    import torch.nn.functional as F_
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, flash_decode, \
        flash_decode_paged, flash_decode_paged_mla, moe_ffn
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.flash_decode import flash_decode_plain
    from repro_torch.kernels.flash_decode_paged import \
        flash_decode_paged_mla_plain, flash_decode_paged_plain
    from repro_torch.kernels.moe_ffn import moe_ffn_plain
    from repro_torch.models.moe import capacity
    from repro_torch.models.tp import TP, heads_of
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(29)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16 = torch.bfloat16
    per = {n: {} for n in ("flash_attention", "flash_decode",
                           "flash_decode_paged", "flash_decode_paged_mla",
                           "moe_ffn")}
    lens, p, n_blk = FAMILY_LENS, 16, 64
    b = len(lens)
    for short, (hq, hc, (a, bb), hd, window) in tp_attention_shapes().items():
        key, hkv = f"tp16_{short}", bb - a
        heads = {"heads": [hq, hkv], "cache_heads": hc}
        # B2: the rank's prefill, its kv heads a slice of the [B, S, Hc,
        # hd] activations (strided views, as the model passes them)
        s = 512
        q = torch.randn((2, s, hq, hd), generator=gen, device=device,
                        dtype=bf16).transpose(1, 2)
        k, v = (torch.randn((2, s, hc, hd), generator=gen, device=device,
                            dtype=bf16)[:, :, a:bb].transpose(1, 2)
                for _ in range(2))
        err = compare_rows(f"flash_attention_{key}",
                           flash_attention(q, k, v, window=window),
                           flash_attention_plain(q, k, v, window=window),
                           shape=[2, hq, hkv, s, hd], window=window, **heads)
        gqa = {"enable_gqa": True} if hkv != hq else {}
        ms, plain_ms, lib_ms = time_calls(
            (lambda: flash_attention(q, k, v, window=window),
             lambda: flash_attention_plain(q, k, v, window=window),
             lambda: sdpa(q, k, v, is_causal=True, **gqa)), flush)
        # SDPA's causal mask is the function only where no window cuts it
        per["flash_attention"][key] = (
            err, ms, plain_ms, (2 * 2 * hq * s * hd + 2 * 2 * hkv * s * hd) * 2,
            4 * 2 * hq * hd * _causal_pairs(s, window),
            lib_ms if window is None or window >= s else None)
        # B8: the rank's heads of a contiguous cache of Hc heads
        qd = torch.randn((b, hq, hd), generator=gen, device=device,
                         dtype=bf16)
        s_buf = 512
        kc, vc, pos, cur = _decode_cache(gen, device, lens, s_buf, hc, hd)
        args = (qd, kc[:, :, a:bb], vc[:, :, a:bb], pos, cur)
        got = flash_decode(*args, window=window)
        err = compare_rows(f"flash_decode_{key}", got,
                           flash_decode_plain(*args, window=window), batch=b,
                           window=window, live_positions=sum(lens), **heads)
        bitwise_rows(f"flash_decode_{key}_rows",
                     lambda *x: flash_decode(*x, window=window), lens,
                     lambda r, _: tuple(t[r:r + 1] for t in args), got)
        valid = (pos >= 0) & (pos <= cur[:, None])
        if window is not None:
            valid &= pos > cur[:, None] - window
        kt, vt = args[1].transpose(1, 2), args[2].transpose(1, 2)
        ms, plain_ms, lib_ms = time_calls(
            (lambda: flash_decode(*args, window=window),
             lambda: flash_decode_plain(*args, window=window),
             lambda: sdpa(qd[:, :, None], kt, vt,
                          attn_mask=valid[:, None, None, :], **gqa)), flush)
        live = int(valid.sum())
        per["flash_decode"][key] = (
            err, ms, plain_ms,
            live * hkv * hd * 2 * 2 + live * 4 + 2 * b * hq * hd * 2 + b * 4,
            4 * live * hq * hd, lib_ms)
        # B4: the rank's heads of a pool of Hc heads
        n = b * 32 + 1
        kp, vp = (torch.randn((n, p, hc, hd), generator=gen, device=device,
                              dtype=bf16) for _ in range(2))
        posp, table, curp = paged_positions(lens, n, p, n_blk, device)
        kv = (kp[:, :, a:bb], vp[:, :, a:bb])
        args = (qd, *kv, posp, table[:, :32], curp)
        err = compare_rows(f"flash_decode_paged_{key}",
                           flash_decode_paged(*args, window=window),
                           flash_decode_paged_plain(*args, window=window),
                           batch=b, window=window, live_positions=sum(lens),
                           **heads)
        bitwise_rows(f"flash_decode_paged_{key}_rows",
                     lambda *x: flash_decode_paged(*x, window=window), lens,
                     lambda r, w: (qd[r:r + 1], *kv, posp,
                                   table[r:r + 1, :w], curp[r:r + 1]),
                     flash_decode_paged(qd, *kv, posp, table, curp,
                                        window=window))
        ms, plain_ms = time_calls(
            (lambda: flash_decode_paged(*args, window=window),
             lambda: flash_decode_paged_plain(*args, window=window)), flush)
        pages, slots = live_work(posp, table[:, :32], curp, window)
        per["flash_decode_paged"][key] = (
            err, ms, plain_ms,
            pages * p * hkv * hd * 2 * 2 + pages * p * 4
            + 2 * b * hq * hd * 2 + b * 32 * 4, 4 * slots * hq * hd)
        del q, k, v, kc, vc, kp, vp
    # B7: rank 0's MLA heads over its rows of wo: MiniCPM3's 3 of 40 (r
    # 256), DeepSeek-V2-Lite's 1 of 16 (r 512, one partial tile of 16)
    n = b * 32 + 1
    posp, table, curp = paged_positions(lens, n, p, n_blk, device)
    pages, slots = live_work(posp, table[:, :32], curp)
    for short, name in (("minicpm3", "minicpm3-4b"),
                        ("deepseek", "deepseek-v2-lite")):
        key, mla = f"tp16_{short}", get_config(name)
        lo, hi = heads_of(TP(None, m=TP_RANKS, r=0), mla.num_heads,
                          mla.v_head_dim)
        h, r, dr = hi - lo, mla.kv_lora_rank, mla.qk_rope_head_dim
        scale = 1.0 / (mla.qk_nope_head_dim + dr) ** 0.5
        ckvp, kropep = (torch.randn((n, p, w), generator=gen, device=device,
                                    dtype=bf16) for w in (r, dr))
        q_lat, q_rope = (torch.randn((b, h, w), generator=gen,
                                     device=device) for w in (r, dr))
        args = (q_lat, q_rope, ckvp, kropep, posp, table[:, :32], curp)
        err = compare_rows(f"flash_decode_paged_mla_{key}",
                           flash_decode_paged_mla(*args, scale=scale),
                           flash_decode_paged_mla_plain(*args, scale=scale),
                           batch=b, heads=h, latent=[r, dr])
        bitwise_rows(f"flash_decode_paged_mla_{key}_rows",
                     lambda *x: flash_decode_paged_mla(*x, scale=scale),
                     lens,
                     lambda i, w: (q_lat[i:i + 1], q_rope[i:i + 1], ckvp,
                                   kropep, posp, table[i:i + 1, :w],
                                   curp[i:i + 1]),
                     flash_decode_paged_mla(q_lat, q_rope, ckvp, kropep,
                                            posp, table, curp, scale=scale))
        ms, plain_ms = time_calls(
            (lambda: flash_decode_paged_mla(*args, scale=scale),
             lambda: flash_decode_paged_mla_plain(*args, scale=scale)),
            flush)
        per["flash_decode_paged_mla"][key] = (
            err, ms, plain_ms,
            pages * p * (r + dr) * 2 + pages * p * 4 + b * h * (r + dr) * 4
            + b * h * r * 4 + b * 32 * 4 + b * 4,
            slots * h * (2 * (r + dr) + 2 * r), None, None, F32_FLOPS)
        del ckvp, kropep
    # B9: a rank's expert slice at an ep_a2a buffer (its TP_ROWS rows'
    # copies from each of the 16 ranks)
    for name in ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"):
        cfg = get_config(name)
        e_loc, d, f = (cfg.num_experts // TP_RANKS, cfg.d_model,
                       cfg.moe_d_ff)
        c = TP_RANKS * capacity(TP_ROWS, cfg.moe_top_k, cfg.num_experts,
                                cfg.moe_capacity_factor)
        xe = torch.randn((e_loc, c, d), generator=gen, device=device,
                         dtype=bf16)
        w1 = (torch.randn((e_loc, d, 2 * f), generator=gen, device=device,
                          dtype=bf16) * d ** -0.5)
        w2 = (torch.randn((e_loc, f, d), generator=gen, device=device,
                          dtype=bf16) * f ** -0.5)
        key = f"tp16_{TP_SHORT[name]}"
        err = compare_rows(f"moe_ffn_{key}", moe_ffn(xe, w1, w2),
                           moe_ffn_plain(xe, w1, w2), experts=e_loc,
                           capacity=c, f=f)

        def library():
            hh = torch.bmm(xe, w1)
            return torch.bmm(F_.silu(hh[..., :f]) * hh[..., f:], w2)
        ms, plain_ms, lib_ms = time_calls(
            (lambda: moe_ffn(xe, w1, w2), lambda: moe_ffn_plain(xe, w1, w2),
             library), flush)
        per["moe_ffn"][key] = (err, ms, plain_ms,
                               e_loc * 3 * d * f * 2 + 2 * e_loc * c * d * 2,
                               e_loc * c * 6 * d * f, lib_ms)
        del xe, w1, w2
    del flush
    for kname, shapes in per.items():
        row = rows[kname]
        for key, v in shapes.items():
            kr = kernel_row(kname, "", "", *v)
            row["shapes"][key] = {k: kr[k] for k in NESTED_KEYS if k in kr}
            row["max_abs_err"] = max(row["max_abs_err"], kr["max_abs_err"])
    return {kname: {key: dict(zip(("max_abs_err", "ms", "plain_ms"), v[:3]))
                    for key, v in shapes.items()}
            for kname, shapes in per.items()}


@contextmanager
def one_rank_mesh():
    """A (1, 1) ("data", "model") mesh bound to a one-rank NCCL group
    (``file://`` rendezvous in a temporary directory; the group destroyed
    at the end, pass or fail)."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            d, "rendezvous"), rank=0, world_size=1)
        try:
            mesh = make_test_mesh((1, 1)).bind()
            if mesh.device.type != "cuda":
                raise AssertionError(f"mesh bound on {mesh.device}")
            yield mesh
        finally:
            dist.destroy_process_group()


def mesh_phase(device, t_start, rows, plan, eager_eager=None):
    """Tensor, expert and data parallelism through the port's entry points
    on a (1, 1) ("data", "model") mesh bound to a one-rank NCCL group
    (``file://`` rendezvous in a temporary directory; the group destroyed
    at the end, pass or fail), with every kernel's plain version forbidden
    on the card while the paths run (module doc, phase 13): (a)
    ``mesh_paths``, (b) ``mesh_train_check``, (c) ``mesh_serve_check``,
    (d) ``tp_kernel_checks``, (e) ``mesh_mla_check``.  At one rank every
    collective is a copy and the data axes split nothing, so (a)-(c) and
    (e) must give the no-mesh bits.  Returns the launch needs (B2, B4,
    B7, B9)."""
    rec = {"phase": "mesh", "mesh": [1, 1], "backend": "nccl"}
    t0 = time.perf_counter()
    with one_rank_mesh() as mesh:
        with torch.no_grad():
            need = mesh_checks(mesh, device, rows, plan, rec)
        gc.collect()
        torch.cuda.empty_cache()
        with forbid_plain(), torch.no_grad():
            need.update(mesh_mla_check(mesh, device, rec))
        gc.collect()
        torch.cuda.empty_cache()
        mesh_train_check(mesh, device, rec, eager_eager)
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        rec["tp16_kernels"] = tp_kernel_checks(device, rows)
    rec.update(seconds=time.perf_counter() - t0,
               seconds_total=time.perf_counter() - t_start, card=card_line())
    emit(rec)
    return need


# --------------------------------------------------------------------------- #
# phase 14: the production dry run on meta, its counts held to the card
# --------------------------------------------------------------------------- #

#: (a) the dry run's cells (arch, shape, 2 x 16 x 16, ``--flash``): the
#: reference's own system-test cell, the largest train step, a prefill
#: through B2, a sliding-window 500k decode, the encoder-decoder's train
#: step, and an expert-parallel decode across the pod axis
DRYRUN_CELLS = (("olmo-1b", "decode_32k", False, False),
                ("qwen3-moe-235b-a22b", "train_4k", False, False),
                ("llama4-scout-17b-a16e", "prefill_32k", False, True),
                ("h2o-danube-1.8b", "long_500k", False, False),
                ("whisper-base", "train_4k", False, False),
                ("qwen3-moe-235b-a22b", "decode_32k", True, False))
#: (b) full-depth OLMoE-1B-7B on the card and on meta: a prefill of 4 x 512
#: tokens (B2, B9) and a decode step of 8 rows over 512 slots (B8, B9);
#: then a train step of 4 x 512 tokens at DRYRUN_TRAIN_LAYERS layers
#: (``ep_a2a``, every layer under remat; plain paths, no kernel), its
#: backward's collectives counted
DRYRUN_STEPS = (("prefill", 512, 4), ("decode", 512, 8), ("train", 512, 4))
#: (b) the train step's depth: its state (params, f32 moments) and saved
#: activations beside the card's other tenants
DRYRUN_TRAIN_LAYERS = 4
#: (b) the card's peak (the inputs' bytes plus what the step allocated
#: over them) over the meta peak must lie in this band, written in PERF.md
#: before the first run
DRYRUN_PEAK_BAND = (0.97, 1.03)
#: (b) timed runs of each step (CUDA events, the median)
DRYRUN_REPS = 11
#: whisper's (1, 1) mesh check: rows, prompt tokens and decode steps
WHISPER_MESH = (2, 16, 2)
#: (b') DRYRUN_STEPS' train step again in ``attn_compute_dtype=
#: "bf16_accum32"`` (the plain ``_sdpa``'s f32 products of bf16 operands,
#: ``models.attention.f32_product``), held as (b) holds it
DRYRUN_BF16_STEP = ("train", 512, 4)
#: (b'') ``_sdpa`` in ``"bf16_accum32"`` at OLMoE's heads, on the card
#: against the CPU route on the same bf16 inputs: rows x tokens, causal
SDPA_BF16_CHECK = (4, 512)
#: (b-f32) DRYRUN_STEPS' prefill and decode again in f32 (B2, B8 and B9 on
#: f32 operands) at DRYRUN_F32_LAYERS layers, held as (b) holds a step
DRYRUN_F32_STEPS = (("prefill", 512, 4), ("decode", 512, 8))
DRYRUN_F32_LAYERS = 4


def dryrun_cells():
    """(a): each cell of DRYRUN_CELLS through ``launch.dryrun.run_cell`` on
    meta, status OK; one ``dryrun_cell`` check line each."""
    from repro_torch.launch import dryrun
    out = []
    for arch, shape, multi, flash in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, multi_pod=multi,
                              opts_kw={"use_flash": flash}, verbose=False)
        if rec["status"] != "OK":
            raise AssertionError(f"dryrun {arch} {shape}: {rec.get('error')}"
                                 f"\n{rec.get('traceback')}")
        r = rec["roofline"]
        line = {"arch": arch, "shape": shape, "mesh": rec["mesh"],
                "flash": flash, "rank": rec["rank"],
                "t_compute": r["t_compute"], "t_memory": r["t_memory"],
                "t_collective": r["t_collective"], "dominant": r["dominant"],
                "bound_time_s": r["bound_time_s"],
                "useful_flops_ratio": r["useful_flops_ratio"],
                "roofline_fraction": r["roofline_fraction"],
                "peak_gb": r["bytes_per_device"] / 1e9,
                "kernel_calls": rec["counts"]["kernel_calls"],
                "collective_bytes": r["collective_breakdown"],
                "seconds": rec["total_s"]}
        emit({"check": "dryrun_cell", **line})
        out.append(line)
    return out


def dryrun_card_step(mesh, device, step_kind, seq, rows, attn="f32",
                     dtype=None):
    """(b) for one step: OLMoE (full depth; a train step at
    DRYRUN_TRAIN_LAYERS) through ``launch.dryrun.build_cell``, with the
    serving path's kernels (``--flash``; B9 in ``ep_a2a`` / ``ep_psum``),
    counted on meta (the (1, 1) mesh placed) and on the card (``mesh``,
    bound); FLOPs, bytes, collectives (the backward's too) and kernel
    calls equal; a train step's all-to-alls three per forward call's
    (forward, remat's rerun, backward: every layer is under remat), the
    forward's counted on meta under no grad; the step timed (CUDA events,
    the median of DRYRUN_REPS) at least the meta count's bound; the card's
    peak within DRYRUN_PEAK_BAND of the meta peak.  ``attn``: the step's
    ``attn_compute_dtype``; ``dtype``: the model's (None: the config's
    bf16; "float32" at DRYRUN_F32_LAYERS).  Returns (line, the
    launches)."""
    from repro_torch import models
    from repro_torch.analysis import record
    from repro_torch.analysis import roofline as rl
    from repro_torch.analysis.counters import count
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    shape = ShapeSpec(f"{step_kind}_{seq}", seq, rows, step_kind)
    train = step_kind == "train"
    cfg = get_config("olmoe-1b-7b")
    if train:
        cfg = cfg.with_(num_layers=DRYRUN_TRAIN_LAYERS)
    if dtype is not None:
        cfg = cfg.with_(dtype=dtype, num_layers=DRYRUN_F32_LAYERS)
    cfg = dryrun.cell_config(cfg, shape)
    opts = dryrun.cell_opts(cfg, shape, use_flash=True,
                            attn_compute_dtype=attn)
    placed = make_test_mesh((1, 1)).place(0)
    step, inputs = dryrun.build_cell(cfg, shape, placed, opts)
    with count(inputs) as dry:
        step()
    a2a = None
    if train:
        with torch.no_grad(), record() as fwd:
            models.loss_fn(inputs["params"], cfg, inputs["batch"],
                           mesh=placed, opts=opts)
        a2a = {"forward_calls": fwd.count_by_kind.get("all-to-all", 0),
               "forward_bytes": fwd.bytes_by_kind.get("all-to-all", 0),
               "step_calls": dry.collectives.count_by_kind.get(
                   "all-to-all", 0),
               "step_bytes": dry.collectives.bytes_by_kind.get(
                   "all-to-all", 0)}
        if (a2a["forward_calls"] != 2 * cfg.num_moe_layers
                or a2a["step_calls"] != 3 * a2a["forward_calls"]
                or a2a["step_bytes"] != 3 * a2a["forward_bytes"]):
            raise AssertionError(f"dryrun train: all-to-alls {a2a}, want "
                                 "three per forward call")
    del step, inputs
    report = rl.analyze_costs(rl.costs_from_counters(dry), cfg, shape,
                              chips=1, mesh_desc="1x1",
                              bytes_per_device=dry.peak_bytes)

    step, inputs = dryrun.build_cell(cfg, shape, mesh, opts, device=device)
    step()                          # first use: scratch buffers, handles
    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    with count(inputs) as real:
        _, launches = counted(step)
    card_peak = (dry.input_bytes + torch.cuda.max_memory_allocated(device)
                 - base)
    got, want = real.as_dict(), dry.as_dict()
    for key in ("flops", "aten_flops", "kernel_flops", "bytes", "aten_bytes",
                "kernel_bytes", "kernel_calls", "collective_bytes",
                "collective_calls"):
        if got[key] != want[key]:
            raise AssertionError(f"dryrun {shape.name}: {key} on the card "
                                 f"{got[key]} != on meta {want[key]}")
    ms = statistics.median(_timed(step, device)[1]
                           for _ in range(DRYRUN_REPS))
    share = report.bound_time / (ms / 1e3)
    if share > 1.0:
        raise AssertionError(f"dryrun {shape.name}: the step took {ms} ms, "
                             f"under its bound {report.bound_time * 1e3} ms")
    ratio = card_peak / dry.peak_bytes
    if not DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1]:
        raise AssertionError(f"dryrun {shape.name}: card peak {card_peak} "
                             f"over meta peak {dry.peak_bytes} = {ratio}, "
                             f"outside {DRYRUN_PEAK_BAND}")
    del step, inputs
    gc.collect()
    torch.cuda.empty_cache()
    line = {"step": shape.name, "rows": rows, "counts": want,
            "t_compute": report.t_compute, "t_memory": report.t_memory,
            "t_collective": report.t_collective,
            "dominant": report.dominant, "bound_ms": report.bound_time * 1e3,
            "ms": ms, "share_of_bound": share,
            "useful_flops_ratio": report.useful_flops_ratio,
            "meta_peak_gb": dry.peak_bytes / 1e9,
            "card_peak_gb": card_peak / 1e9, "peak_ratio": ratio,
            "input_gb": dry.input_bytes / 1e9}
    if train:
        line.update(layers=cfg.num_layers, remat=opts.remat, all_to_all=a2a)
    if attn != "f32":
        line["attn_compute_dtype"] = attn
    if dtype is not None:
        line.update(dtype=dtype, layers=cfg.num_layers)
    return line, launches


def sdpa_bf16_check(device):
    """(b''): ``_sdpa`` in ``"bf16_accum32"`` at OLMoE's heads over
    SDPA_BF16_CHECK's causal rows, on the card (``bmm``'s ``out_dtype``
    form, which must run) against the CPU route (f32 copies) on the same
    bf16 inputs, each (row, token, head) held to ROW_TOL (``compare_rows``'
    check line carries the largest absolute error).  Returns its line."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.configs import get_config
    from repro_torch.models.attention import _mask_bias, _sdpa
    cfg = get_config("olmoe-1b-7b")
    b, s = SDPA_BF16_CHECK
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    gen = torch.Generator().manual_seed(11)
    q = (torch.randn((b, s, hq, hd), generator=gen) * 2).bfloat16()
    k = (torch.randn((b, s, hkv, hd), generator=gen) * 2).bfloat16()
    v = torch.randn((b, s, hkv, hd), generator=gen).bfloat16()
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(func)
            return func(*args, **(kwargs or {}))

    def run(dev):
        t = [x.to(dev) for x in (q, k, v, pos)]
        return _sdpa(*t[:3], _mask_bias(t[3], t[3], None, True), hd ** -0.5,
                     "bf16_accum32")
    with torch.no_grad():
        want = run("cpu")
        with Ops() as ops:
            got = run(device)
        torch.cuda.synchronize()
    if torch.ops.aten.bmm.dtype not in ops.seen:
        raise AssertionError("dryrun sdpa bf16: the card's route ran no "
                             "bmm.dtype")
    err = compare_rows("dryrun_sdpa_bf16_accum32", got.cpu(), want,
                       shape=[b, s, hq, hkv, hd])
    return {"rows": b, "tokens": s, "heads": hq, "kv_heads": hkv,
            "head_dim": hd, "max_abs_err": err, "tol": ROW_TOL}


def whisper_mesh_check(mesh, device):
    """Whisper-base at full width and depth on the (1, 1) mesh: the prefill
    and decode logits bit for bit those of the same steps with no mesh."""
    from repro_torch import models
    from repro_torch.configs import get_config
    cfg = get_config("whisper-base")
    b, p0, steps = WHISPER_MESH
    params = models.init_params(cfg, seed=0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    frames = torch.randn((b, cfg.encoder_seq_len, cfg.d_model),
                         generator=gen, device=device)
    prompt = torch.randint(0, cfg.vocab_size, (b, p0), generator=gen,
                           device=device, dtype=torch.int32)

    def run(m):
        caches = models.init_caches(cfg, b, p0 + steps, device=device)
        lg, caches = models.prefill_fn(params, cfg, {"frames": frames,
                                                     "tokens": prompt},
                                       caches, mesh=m)
        out = [lg]
        for i in range(steps):
            pos = torch.full((b,), p0 + i, dtype=torch.int32, device=device)
            lg, caches = models.decode_fn(params, cfg, out[-1].argmax(-1)
                                          .int(), pos, caches, mesh=m)
            out.append(lg)
        return out
    with torch.no_grad():
        plain, meshed = run(None), run(mesh)
    if not all(torch.equal(a, c) for a, c in zip(plain, meshed)):
        raise AssertionError("whisper: the (1, 1) mesh's logits differ from "
                             "the no-mesh path's")
    return {"rows": b, "prompt": p0, "decode_steps": steps,
            "logits_bitwise": True}


def dryrun_phase(device, t_start):
    """Phase 14 (module doc): (a) ``dryrun_cells`` on meta; (b)
    ``dryrun_card_step`` for each of DRYRUN_STEPS and
    ``whisper_mesh_check`` on a one-rank NCCL (1, 1) mesh; (b') the
    DRYRUN_BF16_STEP in ``"bf16_accum32"`` there; (b-f32) DRYRUN_F32_STEPS
    in f32 there; (b'') ``sdpa_bf16_check``.  Returns the launch needs
    (B2, B8, B9)."""
    t0 = time.perf_counter()
    rec = {"phase": "dryrun", "cells": dryrun_cells(),
           "cells_seconds": time.perf_counter() - t0}
    need = {}
    want = {"prefill": ("flash_attention", "moe_ffn"),
            "decode": ("flash_decode", "moe_ffn"), "train": ()}
    with one_rank_mesh() as mesh:
        rec["steps"] = []
        for kind, seq, rows in DRYRUN_STEPS:
            with torch.set_grad_enabled(kind == "train"):
                line, launches = dryrun_card_step(mesh, device, kind, seq,
                                                  rows)
            rec["steps"].append(line)
            need[f"dryrun_{kind}"] = (launches, want[kind])
        with torch.no_grad():
            rec["whisper_mesh"] = whisper_mesh_check(mesh, device)
        kind, seq, rows = DRYRUN_BF16_STEP
        with torch.enable_grad():
            rec["bf16_step"], launches = dryrun_card_step(
                mesh, device, kind, seq, rows, attn="bf16_accum32")
        need[f"dryrun_{kind}_bf16"] = (launches, ())
        rec["f32_steps"] = []
        for kind, seq, rows in DRYRUN_F32_STEPS:
            with torch.no_grad():
                line, launches = dryrun_card_step(mesh, device, kind, seq,
                                                  rows, dtype="float32")
            rec["f32_steps"].append(line)
            need[f"dryrun_{kind}_f32"] = (launches, want[kind])
    rec["sdpa_bf16"] = sdpa_bf16_check(device)
    gc.collect()
    torch.cuda.empty_cache()
    rec.update(peak_band=DRYRUN_PEAK_BAND,
               seconds=time.perf_counter() - t0,
               seconds_total=time.perf_counter() - t_start, card=card_line())
    emit(rec)
    return need


RESUME_FLAG = "--train-resume"
DIGESTS_FLAG = "--digests"


#: ``--digests``: the configs whose first MoE layer B5 runs on (8 tokens,
#: top-k and k 2, int8 and int4): OLMoE's F 1024, qwen3-moe's F 1536 and
#: llama4-scout's F 8192 (two chunks of pass 2)
DIGEST_QUANT = ("olmoe-1b-7b", "qwen3-moe-235b-a22b", "llama4-scout-17b-a16e")


def digests_main(device) -> int:
    """``--digests [DIR]``: the attention checks (the f32 ones of B2, B8
    and B4 at OLMoE's widths too, and B7's on f32 latents), B5 and B6 on
    f32 activations at the reduced OLMoE layer, and B5's (DIGEST_QUANT,
    on a two-layer cut of each config), untimed, on the package already
    imported (DIR's); prints the digests and the refusals."""
    from repro_torch import models
    from repro_torch.configs import get_config
    cfg, cfg_mla = get_config("olmoe-1b-7b"), get_config("deepseek-v2-lite")
    refused = {}
    for check, c in ((check_flash_attention, cfg), (check_flash_decode, cfg),
                     (check_flash_decode_paged, cfg),
                     (check_flash_decode_paged_mla, cfg_mla)):
        try:
            check(c, None, device)
        except ValueError as e:          # a shape the wrappers refuse
            refused[check.__name__] = str(e)
    try:                                 # f32 (C12), at OLMoE's widths
        f32_attention_checks(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                             F32_LENS, 512, 512, None, device, None,
                             "olmoe", {})
    except (TypeError, ValueError) as e:
        refused["f32_attention_checks"] = str(e)
    try:                                 # B7 on f32 latents
        f32_mla_checks(None, device, {})
    except (TypeError, ValueError) as e:
        refused["f32_mla_checks"] = str(e)
    rcfg = get_config("olmoe-1b-7b").reduced()
    rlayer = models.init_params(rcfg, seed=0,
                                device=device)["layers"][0]["moe"]
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    try:                                 # B5 / B6 on f32 activations
        f32_quant_checks(rlayer, rcfg, torch.randn(
            (128, rcfg.d_model), generator=gen, device=device), None,
            "reduced", {})
    except (TypeError, ValueError) as e:
        refused["f32_quant_checks"] = str(e)
    for name in DIGEST_QUANT:
        c = get_config(name).with_(num_layers=2)
        params = models.init_params(c, seed=0, device=device)
        layer = next(lp["moe"] for lp in params["layers"] if "moe" in lp)
        gen = torch.Generator(device=device)
        gen.manual_seed(9)
        x8 = torch.randn((8, c.d_model), generator=gen, device=device,
                         dtype=torch.bfloat16)
        short = FAMILY_SHORT.get(name, name.split("-")[0])
        try:                             # a refusal, or a failed launch
            check_moe_decode_quant(layer, c, x8, None, f"_{short}",
                                   ks=(c.moe_top_k, 2))
        except (ValueError, RuntimeError) as e:
            refused[f"moe_decode_quant_{short}"] = str(e)
        del params, layer
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    emit({"digests": DIGESTS, "refused": refused})
    return 0


def train_resume_child(device) -> int:
    """The tiny recipe for 20 steps, checkpointed every 5 and killed at step
    12, then resumed; its params, moments and losses must equal an
    uninterrupted run's bit for bit.  Run in a process of its own
    (``chip_smoke.py --train-resume``) with deterministic algorithms, which
    the backward of a gather needs on the card and which no other phase
    should run under."""
    import tempfile
    from repro_torch.launch.serve_lexi import tiny_moe_config
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamW
    from repro_torch.training import train
    from repro_torch.tree import leaves
    torch.use_deterministic_algorithms(True)
    cfg = tiny_moe_config()
    dc = DataConfig(cfg.vocab_size, seq_len=64, global_batch=16, seed=0)
    kw = dict(total_steps=20, device=device,
              optimizer=AdamW(peak_lr=2e-3, total_steps=20, warmup_steps=5))
    with tempfile.TemporaryDirectory() as d:
        try:
            train(cfg, dc, ckpt_dir=d, ckpt_every=5, crash_at_step=12, **kw)
        except RuntimeError as e:
            if "injected crash" not in str(e):
                raise
        else:
            raise AssertionError("train_resume: no crash at step 12")
        resumed = train(cfg, dc, ckpt_dir=d, ckpt_every=5, **kw)
    clean = train(cfg, dc, **kw)
    same = [torch.equal(a, b) for a, b in zip(leaves(clean.state),
                                              leaves(resumed.state))
            if isinstance(a, torch.Tensor)]
    ok = (resumed.resumed_from == 10 and all(same)
          and resumed.losses == clean.losses[10:])
    emit({"resumed_from": resumed.resumed_from, "leaves": len(same),
          "leaves_equal": sum(same),
          "losses_equal": resumed.losses == clean.losses[10:],
          "final_loss": clean.losses[-1]})
    return 0 if ok else 1


def train_resume_phase(t_start):
    """``train_resume_child`` in a child process whose failure fails the
    run; then ``python -m repro_torch.launch.train --arch olmoe-1b-7b
    --reduced --steps 20 --eval --device cuda`` must exit 0."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    rec = {"phase": "train_resume"}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        RESUME_FLAG], env=env, capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    if r.returncode:
        raise AssertionError(f"train_resume child exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    rec.update(json.loads(r.stdout.strip().splitlines()[-1]),
               child_s=time.perf_counter() - t0)
    src = os.path.join(ROOT, "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = ["-m", "repro_torch.launch.train", "--arch", "olmoe-1b-7b",
           "--reduced", "--steps", "20", "--eval", "--device", "cuda"]
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *cmd], env=env, capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    out = r.stdout.strip().splitlines()
    if r.returncode or not out or "held-out perplexity" not in out[-1]:
        raise AssertionError(f"launch.train exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    rec.update(launcher=" ".join(["python"] + cmd), launcher_exit=0,
               launcher_last_lines=out[-2:],
               launcher_s=time.perf_counter() - t0,
               seconds_total=time.perf_counter() - t_start)
    emit(rec)



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    argv = sys.argv[1:]
    digests = argv[:1] == [DIGESTS_FLAG]
    package = os.path.abspath(argv[1]) if digests and argv[1:] else ROOT
    sys.path.insert(0, os.path.join(package, "src"))
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core import optimize
    from repro_torch.kernels import _build
    from repro_torch.serving import Engine
    from repro_torch.tree import leaves

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv == [RESUME_FLAG]:
        return train_resume_child(device)
    if digests:
        return digests_main(device)
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
                           leaves(lp)) / 1e9})

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
        # the OLMoE forward first (its error the largest of the six OLMoE
        # shapes'), then danube's forward at hd 80 (the largest of its
        # three); the row's error is the larger of the two
        "flash_attention": nested_row(
            "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:74",
            check_flash_attention(cfg, flush, device), "shapes"),
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
    # the f32 kernels (C12) at the reduced config's shapes and full width
    for name, per in f32_kernel_checks(layer, cfg, x512, device, flush,
                                       x_fwd=x2048).items():
        row = rows[name]
        for tag, numbers in per.items():
            r = kernel_row(name, row["source"], row["replaces"], *numbers,
                           flop_rate=F32_FLOPS)
            row.setdefault("shapes", {})[tag] = {
                k: r[k] for k in NESTED_KEYS if k in r}
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
    sens_need = sensitivity_check(params, cfg_gmm, device, t_start)
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
    need.update(sens_need)
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
        with first_token_rows(eng) as first:
            res, counts = counted(
                lambda: eng.serve(requests(cfg, seed=0), plan=plan_name))
        if tag == "baseline":
            rows_contig = first
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
    dense_need, rows_dense = serve_dense(params, cfg, plan, device, t_start)
    need.update(dense_need)
    torch.cuda.empty_cache()

    # ---- phase 7b: full-width OLMoE in f32, the reduced launchers -------
    need.update(serve_f32_phase(
        params, cfg, plan, {"paged": rows_base, "contiguous": rows_contig,
                            "dense": rows_dense}, device, t_start))
    need.update(reduced_launchers_phase(device, t_start))
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
                           for t in leaves(params)) / 1e9,
          "kv_bytes_per_token": cfg_mla.num_layers * 2 * (
              cfg_mla.kv_lora_rank + cfg_mla.qk_rope_head_dim),
          "olmoe_kv_bytes_per_token": cfg.num_layers * 2 * 2 * (
              cfg.num_kv_heads * cfg.head_dim_)})
    mla_gmm = cfg_mla.with_(moe_impl="gmm")
    for name, per_shape in mla_checks(params, mla_gmm, device).items():
        rows[name].setdefault("shapes", {}).update(per_shape)
    olmoe_plan = plan
    plan, mla_need = serve_mla(params, mla_gmm, device, t_start)
    need.update(mla_need)
    rec, fwd_counts = forward_phase(params, cfg_mla, plan, device)
    if any(fwd_counts[n] for n in GQA_ATTENTION):
        raise AssertionError(f"forward_mla: attention kernels {fwd_counts}")
    need["forward_mla"] = (fwd_counts, ("moe_ffn", "moe_gmm"))
    emit(dict(rec, phase="forward_mla", launches=fwd_counts,
              seconds_total=time.perf_counter() - t_start))

    # ---- phase 9a: DeepSeek-V2-Lite in f32 with int8 experts -----------
    need.update(serve_f32_mla_phase(params, cfg_mla, device, t_start))
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 9b: seven more architectures at full width ----------------
    need.update(families_phase(device, t_start, rows))
    torch.cuda.empty_cache()

    # ---- phase 9c: mamba2, zamba2 and whisper at full width --------------
    need.update(ssm_encdec_phase(device, t_start))
    torch.cuda.empty_cache()

    # ---- phases 10-12: training and held-out evaluation -----------------
    train_need, eager_eager = train_phase(
        cfg.with_(num_layers=TRAIN_LAYERS), device, t_start)
    need.update(train_need)
    need.update(train_quality_phase(device, t_start))
    train_resume_phase(t_start)

    # ---- phase 13: expert parallelism on a one-card mesh ----------------
    need.update(mesh_phase(device, t_start, rows, olmoe_plan, eager_eager))

    # ---- phase 14: the production dry run on meta, held to the card -----
    need.update(dryrun_phase(device, t_start))

    for step, (counts, names) in need.items():
        for n in names:
            if counts[n] <= 0:
                raise AssertionError(f"{step}: kernel {n} was never launched")
    for n, r in rows.items():
        r["launches"] = sum(c[n] for c, _ in need.values())
    emit({"phase": "done", "steps_checked": len(need),
          "seconds_total": time.perf_counter() - t_start})
    emit({"kernels": list(rows.values())})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0



if __name__ == "__main__":
    sys.exit(main())
