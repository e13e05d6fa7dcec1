"""Time tile shapes of the flash_attention kernel on the card.

    python3 tools/fa_tile_shapes.py [--reps 25] [--dtype bf16|f32|both]

``src/repro_torch/csrc/flash_attention.cu`` fixes the bf16 body's tile
shape in four constants of namespace ``fa`` (``MW`` 16-row slices a warp,
``NWARP`` warps a block, ``BK`` kv rows a tile, ``MIN_BLOCKS`` the launch
bound's blocks per SM), and the f32 body's in three of namespace ``fa32``
(``BQ`` q rows a block, ``BK`` keys a tile, ``MIN_BLOCKS``).  For each
shape in SHAPES (bf16) and F32_SHAPES (f32) this writes a copy of the
source with those constants replaced into ``build/kernels/shapes/`` and
builds it (one ``nvcc`` each, all started together), holds each against
the plain version at the forward's shape and at a ragged GQA shape with a
window (bf16 row by row to ROW_TOL, f32 elementwise to F32_TOL of |plain|
plus the row's scale, as chip_smoke's ``compare_f32``), and times them in
turns, with SDPA beside them, at the Fig. 4 forward's attention shape (B
4, 16 heads, S 512) for hd 128 and 64 (f32: chip_smoke's check shape, hd
128).  One JSON line per (dtype, shape, hd) with the median device ms;
the card's name and power limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import _row_strides, \
    flash_attention_plain  # noqa: E402

#: bf16: (MW, NWARP, BK, MIN_BLOCKS)
SHAPES = ((1, 4, 64, 2), (1, 8, 64, 2), (1, 8, 64, 1), (2, 4, 64, 1),
          (2, 4, 32, 1), (1, 8, 32, 2), (1, 4, 32, 4), (1, 4, 32, 2))
#: f32: (BQ, BK, MIN_BLOCKS); the first is the source as committed
F32_SHAPES = ((64, 64, 2), (64, 32, 3), (32, 64, 3), (32, 32, 4),
              (128, 64, 1))
ROW_TOL = 1e-2
F32_TOL = 2e-5
CONSTS = {"bf16": ("MW", "NWARP", "BK", "MIN_BLOCKS"),
          "f32": ("BQ", "BK", "MIN_BLOCKS")}
#: the key of a shape in the output lines
SHAPE_KEY = {"bf16": "mw_nwarp_bk_minblocks", "f32": "bq_bk_minblocks"}
#: where each body's constants start in the source
NAMESPACE = {"bf16": "namespace fa {", "f32": "namespace fa32 {"}
FLUSH_BYTES = 128 << 20


def _source(dtype, shape) -> str:
    """flash_attention.cu with one body's tile-shape constants set to
    ``shape`` (each constant replaced once, inside that body's
    namespace)."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    at = src.index(NAMESPACE[dtype])
    head, body = src[:at], src[at:]
    for name, val in zip(CONSTS[dtype], shape):
        body, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {val};", body, count=1)
        if n != 1:
            raise RuntimeError(f"flash_attention.cu: no constant {name}")
    return head + body


def _build_shapes(dtypes):
    out_dir = _build.BUILD_DIR / "shapes"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for dtype, shape in ((d, sh) for d in dtypes
                         for sh in (SHAPES if d == "bf16" else F32_SHAPES)):
        stem = out_dir / (f"fa_{dtype}_" + "_".join(map(str, shape)))
        cu = stem.with_suffix(".cu")
        cu.write_text(_source(dtype, shape))
        lib = stem.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[dtype, shape] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(json.dumps({"dtype": key[0], "shape": key[1], "ptxas": regs}),
              flush=True)
        fn = ctypes.CDLL(str(lib)).flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 16 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def _call(fn, q, k, v, window=None):
    b, hq, s, hd = q.shape
    out = torch.empty_like(q)
    st = [x for t in (q, k, out) for x in _row_strides("fa", t)]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
             k.shape[1], s, hd, window or 0, *st,
             int(q.dtype == torch.float32),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA error {err} at launch")
    return out


def _row_err(got, want):
    e = (got.float() - want.float()).norm(dim=-1)
    return (e / want.float().norm(dim=-1).clamp(min=1e-30)).max().item()


def _f32_err(got, want):
    """max |got - want| over F32_TOL (|want| + the row's largest |want|,
    at least 1): chip_smoke's ``compare_f32`` passes at <= 1."""
    row = want.abs().amax(-1, keepdim=True).clamp(min=1.0)
    bound = F32_TOL * want.abs() + F32_TOL * row
    return ((got - want).abs() / bound).max().item()


def _time(fns, flush, reps):
    for f in fns:
        f()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for r in range(reps):
        for i in range(len(fns)):
            j = (i + r) % len(fns)
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(4_000_000)
            a.record()
            fns[j]()
            b.record()
            torch.cuda.synchronize()
            times[j].append(a.elapsed_time(b))
    return [statistics.median(t) for t in times]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=25)
    ap.add_argument("--dtype", choices=("bf16", "f32", "both"),
                    default="both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fa_tile_shapes: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    dtypes = ("bf16", "f32") if args.dtype == "both" else (args.dtype,)
    fns = _build_shapes(dtypes)
    dev = torch.device("cuda")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype in dtypes:
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        err_of = _row_err if dtype == "bf16" else _f32_err
        tol = ROW_TOL if dtype == "bf16" else 1.0
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=dt)

        ragged = (rnd(2, 16, 200, 128), rnd(2, 4, 200, 128),
                  rnd(2, 4, 200, 128))
        want_ragged = flash_attention_plain(*ragged, window=100)
        mine = {key[1]: fn for key, fn in fns.items() if key[0] == dtype}
        for hd in ((128, 64) if dtype == "bf16" else (128,)):
            q, k, v = (rnd(4, 16, 512, hd), rnd(4, 16, 512, hd),
                       rnd(4, 16, 512, hd))
            want = flash_attention_plain(q, k, v)
            errs = {}
            for shape, fn in mine.items():
                errs[shape] = max(err_of(_call(fn, q, k, v), want),
                                  err_of(_call(fn, *ragged, window=100),
                                         want_ragged))
            calls = [lambda fn=fn: _call(fn, q, k, v) for fn in mine.values()]
            ms = _time(calls + [lambda: sdpa(q, k, v, is_causal=True)],
                       flush, args.reps)
            for (shape, err), t in zip(errs.items(), ms):
                print(json.dumps({"dtype": dtype, "hd": hd,
                                  SHAPE_KEY[dtype]: shape,
                                  "ms": t, "sdpa_ms": ms[-1],
                                  "x_sdpa": t / ms[-1], "max_err": err,
                                  "err": "row_rel" if dtype == "bf16"
                                  else "over_f32_tol",
                                  "ok": err <= tol}), flush=True)


if __name__ == "__main__":
    main()
