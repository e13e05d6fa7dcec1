#!/usr/bin/env python3
"""Time the expert kernels moe_ffn (B9) and moe_decode (B3) of one checkout
at the shapes the main paths give them, on one NVIDIA GPU.

    python3 tools/expert_kernel_times.py [--root DIR] [--tag NAME]

``repro_torch`` is imported from ``DIR/src`` (default: this checkout) and
its kernels are built there; the inputs, checks and timers are this
checkout's ``chip_smoke.py``'s.  Run it in turns with the root of another
checkout (an older commit unpacked by ``git archive``) in one call on one
card -- other, this, this, other -- to compare two versions of a kernel.

Shapes: moe_ffn on OLMoE-1B-7B's capacity buffers (C 320, 80, 4: the
forward's 4 x 512 tokens, a serve chunk's 8 x 64, a decode step's 8 slots)
and on DeepSeek-V2-Lite's at C 4 (F 1408 and the intra-pruned 1056), each
with the bf16 ``bmm`` pair as ``library_ms``; moe_decode on 8 tokens
routed by each model's router at its top-k and at k 2 (and OLMoE's on one
token).  Each timing is
held to the plain version first.  Prints one JSON line, then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    sys.path.insert(1, HERE)
    import torch
    if not torch.cuda.is_available():
        print("expert_kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.core import intra_prune
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    secs = _build.build_all()
    flush = torch.empty(cs.FLUSH_BYTES, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rec = {"tag": args.tag, "root": os.path.abspath(args.root),
           "build_s": secs, "moe_ffn": {}, "moe_decode": {}}

    def ffn(layer, cfg, x, name):
        err, ms, plain_ms, nbytes, flops, lib_ms = cs.check_moe_ffn(
            layer, cfg, x, flush, name)
        rec["moe_ffn"][name] = cs.kernel_row(
            "moe_ffn", "", "", err, ms, plain_ms, nbytes, flops, lib_ms)

    def decode(layer, cfg, x, name):
        for key, v in cs.check_moe_decode(layer, cfg, x, flush,
                                          "_" + name).items():
            rec["moe_decode"][f"{name}_{key}"] = cs.kernel_row(
                "moe_decode", "", "", *v)

    cfg = get_config("olmoe-1b-7b")
    params = models.init_params(cfg.with_(num_layers=1), seed=0, device=dev)
    layer = params["layers"][0]["moe"]
    x = torch.randn((2048, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    for name, xx in (("olmoe_forward_c320", x), ("olmoe_chunk_c80", x[:512]),
                     ("olmoe_decode_c4", x[:8])):
        ffn(layer, cfg, xx, name)
    decode(layer, cfg, x[:8].contiguous(), "olmoe")
    decode(layer, cfg, x[:1].contiguous(), "olmoe_b1")
    del params, layer

    cfg = get_config("deepseek-v2-lite").with_(num_layers=2)
    params = models.init_params(cfg, seed=0, device=dev)
    pruned, cfg_p = intra_prune(params, cfg, 0.25)
    x8 = x[:8].contiguous()
    for lay, c in ((params["layers"][1]["moe"], cfg),
                   (pruned["layers"][1]["moe"], cfg_p)):
        f = c.moe_d_ff
        ffn(lay, c, x8, f"deepseek_decode_f{f}_c4")
        decode(lay, c, x8, f"deepseek_f{f}")
    print(json.dumps(rec), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
