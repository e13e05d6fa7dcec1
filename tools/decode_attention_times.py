#!/usr/bin/env python3
"""Time the decode attention kernels flash_decode (B8, contiguous cache),
flash_decode_paged (B4) and flash_decode_paged_mla (B7, on bf16 and on f32
latents) of one checkout at serve's decode shapes and at chip_smoke's
check shapes, on one NVIDIA GPU, with a digest of every output; or, with
``--variants``, candidate launch constants and bodies of B7's f32 instance.

    python3 tools/decode_attention_times.py [--root DIR] [--tag NAME]
    python3 tools/decode_attention_times.py --variants [--reps 15]

``repro_torch`` is imported from ``DIR/src`` (default: this checkout) and
its kernels are built there; the inputs, checks and timers are this
checkout's ``chip_smoke.py``'s.  Run it in turns with the root of another
checkout (an older commit unpacked by ``git archive``) in one call on one
card -- other, this, this, other -- to compare two versions of a kernel:
the inputs are the same in every turn, so equal digests mean equal bits.

Shapes: B8 at OLMoE-1B-7B's widths (16 query and kv heads of 128) over a
512-slot cache, at a batch of 1 and of 8 rows whose longest row holds 64,
128, 256 and 512 positions (the other rows of 8 hold 7/8, 6/8, ... 1/8 of
it); B4 at the same widths and B7 at DeepSeek-V2-Lite's (16 heads, r 512,
dr 64), pages of 16 slots, at a batch of 1 and of 8 rows with a table view
of 4, 8, 16 and 32 columns (``KVCache.live_blocks``): the longest row fills
the view, as in a serve, and the other rows of 8 hold 7/8, 6/8, ... 1/8 of
it; B7 again on f32 latents at the same shapes (``flash_decode_paged_mla_
f32``, its own generator).  Each call is held to the plain version row by
row (ROW_TOL; f32 elementwise, as chip_smoke's ``compare_f32``) before it
is timed (median of CUDA-event times, L2 flushed before every call; B8
beside the library's attention with a boolean mask).  ``graph_ms`` is the
per-call time of GRAPH_CALLS calls captured in one CUDA graph
(``kernels/_graphs.py``) and replayed (median of the replays over
GRAPH_CALLS; the L2 warm after the first call), which the event timer's
floor (``empty_ms``) does not hide.  ``check`` runs chip_smoke's own B8,
B4 and B7 checks, every shape, and B7's f32 checks (``f32_mla_checks``:
DeepSeek's 16 heads at r 512, MiniCPM3's 40 at r 256, the reduced
config's 4 at r 32; each with its ``graph_ms``), timed only: the bits of a
row alone against the batch are chip_smoke's to hold.  ``digests`` holds a
sha256 (16 hex digits) of each kernel output held to its plain version, by
check name.  ``empty_ms`` is the same timer around a one-element add: the
launch, the events and a cold L2 that every time above includes.  Prints
one JSON line, then the card's name and power limit.

``--variants`` builds each entry of VARIANTS -- ``csrc/flash_decode_paged_
mla.cu`` with launch constants of its f32 instance replaced (head tile,
ring stages, blocks an SM, the score and P.V patches) or a line swapped
(the walk's tile count 0: the launch, q, the page list and the cluster
merge alone), or another body from ``tools/variants/`` in the source's
place -- into ``build/kernels/variants/`` (``tools/kernel_variants.py``:
one ``nvcc`` each, all started together), holds each on f32 latents to the plain version (``compare_f32``'s
bound) and to the committed source's bits (``same_bits``), and times them
in turns at the f32 serve shapes and the three f32 check shapes, event
timer and graph.  One JSON line per (variant, shape); the card's name and
power limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGE = 16
#: calls a CUDA graph holds for ``graph_ms``, and its replays
GRAPH_CALLS = 20
GRAPH_REPS = 15

#: the f32 body's tile count with the lines before it (the bf16 body has
#: the same count line after other lines); the walk-less variant swaps it
_F32_WALK = ("  pd_cp_async_commit();\n"
             "  mla_page_list(bt + (size_t)b * bt_stride, n_blk, rank, list,"
             " n_pages_s);\n  __syncthreads();\n"
             "  const int n_tiles = *n_pages_s * tpp;\n")
#: candidates of B7's f32 instance (``tools/kernel_variants.py``:
#: constants of csrc/flash_decode_paged_mla.cu, "edits", or "source": a
#: body from the root of the checkout); the first is the source as
#: committed; "check": False for a timing variant whose output is not the
#: function
VARIANTS = [
    {},
    {"F32_STAGES_512": 4, "F32_STAGES_256": 4, "F32_BLOCKS_256": 2},
    {"F32_SC_PS": 4},
    {"F32_SC_UNROLL": 8},
    {"F32_PV_H": 8, "F32_HT_32": 8},
    {"edits": [[_F32_WALK, _F32_WALK.replace("*n_pages_s * tpp", "0")]],
     "check": False},
]


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def graph_ms(fn, calls: int = GRAPH_CALLS, reps: int = GRAPH_REPS) -> float:
    """Per-call ms of ``calls`` calls of ``fn`` captured in one CUDA graph,
    median over ``reps`` replays."""
    import torch
    from repro_torch.kernels import _graphs
    stream = _graphs.side_stream(torch.device("cuda"))
    _graphs.on_stream(fn, stream)
    g = _graphs.capture(lambda: [fn() for _ in range(calls)], stream=stream,
                        pool=torch.cuda.graph_pool_handle())
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def sm_mhz(cycles: int = 20_000_000) -> float:
    """The SM clock while busy: ``torch.cuda._sleep`` spins for a count of
    SM cycles, timed with CUDA events."""
    import torch
    torch.cuda._sleep(cycles // 10)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / (start.elapsed_time(end) * 1e3)


def serve_shapes(gen, dev, dtype):
    """(tag, B7 arguments, (pages, slots), live columns) at serve's decode
    shapes: DeepSeek-V2-Lite's widths, latents of ``dtype``."""
    import chip_smoke as cs
    from repro_torch.configs import get_config
    cfgm = get_config("deepseek-v2-lite")
    h, r, dr = cfgm.num_heads, cfgm.kv_lora_rank, cfgm.qk_rope_head_dim
    for b in (1, 8):
        for live in (4, 8, 16, 32):
            lens = [live * PAGE * (b - i) // b for i in range(b)]
            n = sum(-(-ln // PAGE) for ln in lens) + 1
            posp, table, cur = cs.paged_positions(lens, n, PAGE, live, dev)
            args = tuple(torch_randn(gen, dev, s, d) for s, d in (
                ((b, h, r), None), ((b, h, dr), None), ((n, PAGE, r), dtype),
                ((n, PAGE, dr), dtype))) + (posp, table, cur)
            yield f"b{b}_cols{live}", args, cs.live_work(posp, table, cur), \
                live


def torch_randn(gen, dev, shape, dtype=None):
    import torch
    return torch.randn(shape, generator=gen, device=dev,
                       dtype=dtype or torch.float32)


def mla_numbers(args, live, work, elem):
    """(bytes, flops) of B7 on ``args`` (latents of ``elem`` bytes)."""
    b, h, r = args[0].shape
    dr = args[1].shape[2]
    pages, slots = work
    nbytes = (pages * PAGE * (r + dr) * elem + pages * PAGE * 4
              + b * h * (r + dr) * 4 + b * h * r * 4 + 4 * b * live + 4 * b)
    return nbytes, slots * h * (2 * (r + dr) + 2 * r)


def times_main(args) -> int:
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    sys.path.insert(1, HERE)
    import torch
    if not torch.cuda.is_available():
        print("decode_attention_times: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, flash_decode, \
        flash_decode_paged, flash_decode_paged_mla
    from repro_torch.kernels.flash_decode import flash_decode_plain
    from repro_torch.kernels.flash_decode_paged import \
        flash_decode_paged_mla_plain, flash_decode_paged_plain
    fdp = sys.modules["repro_torch.kernels.flash_decode_paged"]
    if not hasattr(fdp, "mla_f32_launch_shape"):
        # a root from before the f32 launch could be read: its checks'
        # "launch" is null
        fdp.mla_f32_launch_shape = lambda *a: None

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    secs = _build.build_all()
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    rec = {"tag": args.tag, "root": os.path.abspath(args.root),
           "build_s": secs, "flash_decode": {}, "flash_decode_paged": {},
           "flash_decode_paged_mla": {}, "flash_decode_paged_mla_f32": {},
           "digests": {}}
    compare_rows = cs.compare_rows

    def digested(name, got, want, **extra):
        rec["digests"][name] = hashlib.sha256(
            got.contiguous().view(-1).view(torch.uint8).cpu().numpy()
            .tobytes()).hexdigest()[:16]
        return compare_rows(name, got, want, **extra)

    cs.compare_rows = digested
    cfg, cfgm = get_config("olmoe-1b-7b"), get_config("deepseek-v2-lite")
    hq, hd = cfg.num_heads, cfg.head_dim_
    hkv = cfg.num_kv_heads
    h, r, dr = cfgm.num_heads, cfgm.kv_lora_rank, cfgm.qk_rope_head_dim
    scale = 1.0 / (cfgm.qk_nope_head_dim + dr) ** 0.5

    one = torch.zeros(1, device=dev)
    rec["empty_ms"], = cs.time_calls((lambda: one.add_(1),), flush)
    rec["sm_mhz"] = sm_mhz()
    rec["empty_graph_ms"] = graph_ms(lambda: one.add_(1))

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b in (1, 8):
        for longest in (64, 128, 256, 512):
            tag = f"b{b}_len{longest}"
            lens = [longest * (b - i) // b for i in range(b)]
            k, v, pos, cur = cs._decode_cache(gen, dev, lens, 512, hkv, hd)
            fargs = (randn(b, hq, hd), k, v, pos, cur)
            err = cs.compare_rows(f"flash_decode_{tag}", flash_decode(*fargs),
                                  flash_decode_plain(*fargs))
            qm, kt, vt = fargs[0][:, :, None], k.transpose(1, 2), \
                v.transpose(1, 2)
            mask = ((pos >= 0) & (pos <= cur[:, None]))[:, None, None, :]
            ms, plain_ms, lib_ms = cs.time_calls(
                (lambda: flash_decode(*fargs),
                 lambda: flash_decode_plain(*fargs),
                 lambda: sdpa(qm, kt, vt, attn_mask=mask)), flush)
            live = sum(lens)
            nbytes = (live * hkv * hd * 4 + live * 4 + 4 * b * hq * hd
                      + 4 * b)
            rec["flash_decode"][tag] = cs.kernel_row(
                "flash_decode", "", "", err, ms, plain_ms, nbytes,
                4 * live * hq * hd, lib_ms,
                {"graph_ms": graph_ms(lambda: flash_decode(*fargs))})

    for b in (1, 8):
        for live in (4, 8, 16, 32):
            tag = f"b{b}_cols{live}"
            lens = [live * PAGE * (b - i) // b for i in range(b)]
            n = sum(-(-ln // PAGE) for ln in lens) + 1
            posp, table, cur = cs.paged_positions(lens, n, PAGE, live, dev)
            pages, slots = cs.live_work(posp, table, cur)

            gqa = (randn(b, hq, hd), randn(n, PAGE, hkv, hd),
                   randn(n, PAGE, hkv, hd), posp, table, cur)
            err = cs.compare_rows(f"flash_decode_paged_{tag}",
                                  flash_decode_paged(*gqa),
                                  flash_decode_paged_plain(*gqa))
            ms, = cs.time_calls((lambda: flash_decode_paged(*gqa),), flush)
            nbytes = (pages * PAGE * hkv * hd * 4 + pages * PAGE * 4
                      + 4 * b * hq * hd + 4 * b * live)
            rec["flash_decode_paged"][tag] = cs.kernel_row(
                "flash_decode_paged", "", "", err, ms, None, nbytes,
                4 * slots * hq * hd, None,
                {"graph_ms": graph_ms(lambda: flash_decode_paged(*gqa))})

            mla = (randn(b, h, r, dtype=torch.float32),
                   randn(b, h, dr, dtype=torch.float32),
                   randn(n, PAGE, r), randn(n, PAGE, dr), posp, table, cur)
            err = cs.compare_rows(
                f"flash_decode_paged_mla_{tag}",
                flash_decode_paged_mla(*mla, scale=scale),
                flash_decode_paged_mla_plain(*mla, scale=scale))
            ms, = cs.time_calls(
                (lambda: flash_decode_paged_mla(*mla, scale=scale),), flush)
            rec["flash_decode_paged_mla"][tag] = cs.kernel_row(
                "flash_decode_paged_mla", "", "", err, ms, None,
                *mla_numbers(mla, live, (pages, slots), 2), None,
                {"graph_ms": graph_ms(
                    lambda: flash_decode_paged_mla(*mla, scale=scale))},
                flop_rate=cs.F32_FLOPS)

    # B7 on f32 latents at the same shapes, from a generator of its own
    gen32 = torch.Generator(device=dev)
    gen32.manual_seed(12)
    for tag, mla, work, live in serve_shapes(gen32, dev, torch.float32):
        err = cs.compare_f32(
            f"flash_decode_paged_mla_f32_{tag}",
            flash_decode_paged_mla(*mla, scale=scale),
            flash_decode_paged_mla_plain(*mla, scale=scale))
        ms, = cs.time_calls(
            (lambda: flash_decode_paged_mla(*mla, scale=scale),), flush)
        rec["flash_decode_paged_mla_f32"][tag] = cs.kernel_row(
            "flash_decode_paged_mla", "", "", err, ms, None,
            *mla_numbers(mla, live, work, 4), None,
            {"graph_ms": graph_ms(
                lambda: flash_decode_paged_mla(*mla, scale=scale))},
            flop_rate=cs.F32_FLOPS)

    cs.bitwise_rows = lambda *a, **k: None
    rec["check"] = {
        name: {tag: cs.kernel_row(name, "", "", *v)
               for tag, v in fn(c, flush, dev).items()}
        for name, fn, c in (
            ("flash_decode", cs.check_flash_decode, cfg),
            ("flash_decode_paged", cs.check_flash_decode_paged, cfg),
            ("flash_decode_paged_mla", cs.check_flash_decode_paged_mla,
             cfgm))}
    per = {}
    cs.f32_mla_checks(flush, dev, per)
    f32 = rec["check"]["flash_decode_paged_mla_f32"] = {
        tag: cs.kernel_row("flash_decode_paged_mla", "", "", *v,
                           flop_rate=cs.F32_FLOPS)
        for tag, v in per["flash_decode_paged_mla"].items()}
    for tag, _, _, _, sc, full in cs.f32_mla_inputs(dev):
        view = full[:5] + (full[5][:, :32], full[6])
        f32[f"f32_{tag}"]["graph_ms"] = graph_ms(
            lambda: flash_decode_paged_mla(*view, scale=sc))
    rec["digests"].update(cs.DIGESTS)
    print(json.dumps(rec), flush=True)
    print(smi_line(), flush=True)
    return 0


# --------------------------------------------------------------------------- #
# --variants: candidate f32 bodies of B7
# --------------------------------------------------------------------------- #


def build_variants():
    """One library a variant (all built at once); prints each build's
    registers and spills."""
    import kernel_variants
    libs = kernel_variants.build({
        f"flash_decode_paged_mla_{i}": ("flash_decode_paged_mla", v)
        for i, v in enumerate(VARIANTS)})
    fns = []
    for i, v in enumerate(VARIANTS):
        lib, ptxas = libs[f"flash_decode_paged_mla_{i}"]
        fn = lib.flash_decode_paged_mla_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns.append(fn)
        print(json.dumps({"variant": i, "consts": v, "ptxas": ptxas}),
              flush=True)
    return fns


def launch_variant(fn, args, scale):
    """B7 through a variant's C function, as the wrapper launches it."""
    import torch
    q_lat, q_rope, ckvp, kropep, posp, bt, cur = args
    b, h, r = q_lat.shape
    n, p, dr = kropep.shape
    out = torch.empty((b, h, r), dtype=torch.float32, device=q_lat.device)
    err = fn(q_lat.data_ptr(), q_rope.data_ptr(), ckvp.data_ptr(),
             kropep.data_ptr(), posp.data_ptr(), bt.data_ptr(),
             cur.data_ptr(), out.data_ptr(), b, h, r, dr, p, bt.shape[1],
             bt.stride(0), int(ckvp.dtype == torch.float32), scale,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA error {err} at launch")
    return out


def variants_main(args) -> int:
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(1, HERE)
    import torch
    if not torch.cuda.is_available():
        print("decode_attention_times: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode_paged import \
        flash_decode_paged_mla_plain
    print(smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants()
    print(json.dumps({"sm_mhz": sm_mhz()}), flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    cfgm = get_config("deepseek-v2-lite")
    scale_ds = 1.0 / (cfgm.qk_nope_head_dim + cfgm.qk_rope_head_dim) ** 0.5
    gen32 = torch.Generator(device=dev)
    gen32.manual_seed(12)
    shapes = [(tag, a, scale_ds) for tag, a, _, _ in
              serve_shapes(gen32, dev, torch.float32)]
    shapes += [(f"check_{tag}", full[:5] + (full[5][:, :32], full[6]), sc)
               for tag, _, _, _, sc, full in cs.f32_mla_inputs(dev)]
    for tag, a, scale in shapes:
        want = flash_decode_paged_mla_plain(*a, scale=scale)
        row = want.abs().amax(-1, keepdim=True).clamp(min=1.0)
        outs = [launch_variant(fn, a, scale) for fn in libs]
        torch.cuda.synchronize()
        ms = cs.time_calls([lambda fn=fn: launch_variant(fn, a, scale)
                            for fn in libs], flush, args.reps)
        for i, (fn, got) in enumerate(zip(libs, outs)):
            checked = VARIANTS[i].get("check", True)
            over = ((got - want).abs() / (cs.F32_TOL * (want.abs() + row))
                    ).max().item()
            print(json.dumps({
                "variant": i, "consts": VARIANTS[i], "shape": tag,
                "ms": ms[i],
                "graph_ms": graph_ms(lambda fn=fn: launch_variant(fn, a,
                                                                  scale)),
                "max_err_over_tol": over if checked else None,
                "same_bits": torch.equal(got, outs[0]),
                "ok": over <= 1.0 or not checked}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    return variants_main(args) if args.variants else times_main(args)


if __name__ == "__main__":
    sys.exit(main())
