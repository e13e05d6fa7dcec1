#!/usr/bin/env python3
"""Time the decode attention kernels flash_decode (B8, contiguous cache),
flash_decode_paged (B4) and flash_decode_paged_mla (B7) of one checkout at
serve's decode shapes and at chip_smoke's check shapes, on one NVIDIA GPU,
with a digest of every output.

    python3 tools/decode_attention_times.py [--root DIR] [--tag NAME]

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
it.  Each call is held to the plain version row by row (ROW_TOL) before it
is timed (median of CUDA-event times, L2 flushed before every call; B8
beside the library's attention with a boolean mask).  ``check`` runs
chip_smoke's own B8, B4 and B7 checks, every shape (timed only: the bits
of a row alone against the batch are chip_smoke's to hold).  ``digests``
holds a sha256 (16 hex digits) of each kernel output held to its plain
version, by check name.  ``empty_ms`` is the same timer around a
one-element add: the launch, the events and a cold L2 that every time
above includes.  Prints one JSON line, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGE = 16


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
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

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    secs = _build.build_all()
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    rec = {"tag": args.tag, "root": os.path.abspath(args.root),
           "build_s": secs, "flash_decode": {}, "flash_decode_paged": {},
           "flash_decode_paged_mla": {}, "digests": {}}
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

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b in (1, 8):
        for longest in (64, 128, 256, 512):
            tag = f"b{b}_len{longest}"
            lens = [longest * (b - i) // b for i in range(b)]
            k, v, pos, cur = cs._decode_cache(gen, dev, lens, 512, hkv, hd)
            args = (randn(b, hq, hd), k, v, pos, cur)
            err = cs.compare_rows(f"flash_decode_{tag}", flash_decode(*args),
                                  flash_decode_plain(*args))
            qm, kt, vt = args[0][:, :, None], k.transpose(1, 2), \
                v.transpose(1, 2)
            mask = ((pos >= 0) & (pos <= cur[:, None]))[:, None, None, :]
            ms, plain_ms, lib_ms = cs.time_calls(
                (lambda: flash_decode(*args),
                 lambda: flash_decode_plain(*args),
                 lambda: sdpa(qm, kt, vt, attn_mask=mask)), flush)
            live = sum(lens)
            nbytes = (live * hkv * hd * 4 + live * 4 + 4 * b * hq * hd
                      + 4 * b)
            rec["flash_decode"][tag] = cs.kernel_row(
                "flash_decode", "", "", err, ms, plain_ms, nbytes,
                4 * live * hq * hd, lib_ms)

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
                4 * slots * hq * hd)

            mla = (randn(b, h, r, dtype=torch.float32),
                   randn(b, h, dr, dtype=torch.float32),
                   randn(n, PAGE, r), randn(n, PAGE, dr), posp, table, cur)
            err = cs.compare_rows(
                f"flash_decode_paged_mla_{tag}",
                flash_decode_paged_mla(*mla, scale=scale),
                flash_decode_paged_mla_plain(*mla, scale=scale))
            ms, = cs.time_calls(
                (lambda: flash_decode_paged_mla(*mla, scale=scale),), flush)
            nbytes = (pages * PAGE * (r + dr) * 2 + pages * PAGE * 4
                      + b * h * (r + dr) * 4 + b * h * r * 4 + 4 * b * live
                      + 4 * b)
            rec["flash_decode_paged_mla"][tag] = cs.kernel_row(
                "flash_decode_paged_mla", "", "", err, ms, None, nbytes,
                slots * h * (2 * (r + dr) + 2 * r), flop_rate=cs.F32_FLOPS)

    cs.bitwise_rows = lambda *a, **k: None
    rec["check"] = {
        name: {tag: cs.kernel_row(name, "", "", *v)
               for tag, v in fn(c, flush, dev).items()}
        for name, fn, c in (
            ("flash_decode", cs.check_flash_decode, cfg),
            ("flash_decode_paged", cs.check_flash_decode_paged, cfg),
            ("flash_decode_paged_mla", cs.check_flash_decode_paged_mla,
             cfgm))}
    print(json.dumps(rec), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
