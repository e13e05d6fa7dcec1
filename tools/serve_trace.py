#!/usr/bin/env python3
"""Trace a serve of one checkout with torch.profiler and sum the decode
attention kernels' device time, on one NVIDIA GPU.

    python3 tools/serve_trace.py [--root DIR] [--tag NAME] \\
        [--modes graphs,eager] [--prefix-cache] -- SERVE_ARGS

Runs ``repro_torch.launch.serve`` of ``DIR/src`` (default: this checkout)
with ``SERVE_ARGS`` and ``--profile``, once for each of ``--modes`` in
turn: ``graphs`` (the launcher's default: every step a CUDA graph replay),
``eager`` (adds ``--eager``), or ``default`` (the launcher's default for a
checkout that has no ``--eager``, where every step is eager).  With
``--prefix-cache`` each mode runs twice in turn: as given (the cache off),
then with the launcher's ``--prefix-cache`` added, where the launcher's
warm-up wave fills the cache and the traced wave, the same requests, is a
warm prefix serve (every full page of each prompt mapped in).  The
launcher prints its own lines (report, device busy and idle share, top
kernels), and this tool adds one JSON line per traced serve with every
CUDA kernel's device time and call count whose name starts with one of
ATTENTION (the contiguous and the paged GQA kernels, and the MLA kernels
of either design: one launch or a partial and a merge pass) and their sum.
Run it on two checkouts in one call on one card to compare their serves,
e.g. the paged OLMoE bf16 serve of PERF.md §5 (``--cache-layout
contiguous --prefill-chunk 0 --use-flash --use-flash-decode`` in place of
``--prefill-chunk 64 --use-kernel`` for the contiguous one):

    python3 tools/serve_trace.py -- --arch olmoe-1b-7b --requests 8 \\
        --max-new 32 --max-batch 8 --max-len 512 --prompt-lo 32 \\
        --prompt-hi 256 --prefill-chunk 64 --use-kernel --use-moe-decode \\
        --use-moe-kernel --moe-impl gmm
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: kernel name prefixes summed (B8; B4; B7 as one kernel or two passes)
ATTENTION = ("flash_decode_kernel", "flash_decode_paged_kernel",
             "mla_decode_kernel", "mla_partial_kernel", "mla_merge_kernel")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    ap.add_argument("--modes", default="graphs,eager",
                    help="comma list of graphs, eager, default: the serves "
                         "traced, in this order")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="trace each mode with the cache off, then warm "
                         "(the launcher's --prefix-cache), in turns")
    ap.add_argument("serve_args", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    import torch
    if not torch.cuda.is_available():
        print("serve_trace: CUDA is not available", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    import repro_torch.launch.serve as serve

    breakdown = serve._device_breakdown
    mode = {"now": "", "prefix_cache": False}

    def with_attention(tag, prof, wall_s, top=10):
        breakdown(tag, prof, wall_s, top)
        rows = {}
        for e in prof.key_averages():
            t = (getattr(e, "self_device_time_total", 0)
                 or getattr(e, "self_cuda_time_total", 0))
            # a template kernel's name carries its return type
            name = e.key[5:] if e.key.startswith("void ") else e.key
            if t > 0 and e.device_type != DeviceType.CPU \
                    and name.startswith(ATTENTION):
                rows[e.key[:90]] = {"ms": t / 1e3, "calls": e.count}
        print(json.dumps({"attention": tag, "tag": args.tag,
                          "mode": mode["now"],
                          "prefix_cache": mode["prefix_cache"],
                          "root": os.path.abspath(args.root),
                          "ms": sum(r["ms"] for r in rows.values()),
                          "kernels": rows}), flush=True)

    serve._device_breakdown = with_attention
    rest = [a for a in args.serve_args if a != "--"]
    for m in args.modes.split(","):
        if m not in ("graphs", "eager", "default"):
            raise SystemExit(f"serve_trace: unknown mode {m!r}")
        for pc in (False, True) if args.prefix_cache else (False,):
            mode.update(now=m, prefix_cache=pc)
            print(json.dumps({"serve_trace": m, "prefix_cache": pc,
                              "tag": args.tag,
                              "root": os.path.abspath(args.root)}),
                  flush=True)
            rc = serve.main(rest + ["--profile"]
                            + (["--eager"] if m == "eager" else [])
                            + (["--prefix-cache"] if pc else []))
            torch.cuda.empty_cache()
            if rc:
                return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
