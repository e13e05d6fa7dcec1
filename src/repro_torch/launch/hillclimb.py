"""The §Perf hillclimb: named optimization variants of three production
cells, each run through the port's dry run (``launch/dryrun.py``) on the
``meta`` device and counted -- the port's counterpart of the reference's
``experiments/perf/hillclimb.py``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell A|B|C|all \
        [--variant TAG] [--out DIR]

``CELLS`` is the reference's table as it stands: the same three cells and
22 tags with the same keyword arguments for ``run_cell``.  A variant that
asks for one of the reference's XLA levers (``XLA_LEVERS``: unrolling the
layer scan, activation sharding constraints), which the port's eager
program has no counterpart of, is recorded as ``SKIP`` with the reason;
it is never run with the lever dropped.  One line a variant: its status,
and for an ``OK`` its dominant term, the three terms, the roofline
fraction, the counted peak bytes of a rank and the rank reported.  With
``--out`` each variant's record is written there as JSON (the dry run's
record plus ``tag``); nothing is written without it.

Every figure is a count of the eager per-rank program against the H100
SXM constants of ``analysis/roofline.py``: no card runs.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

from repro_torch.launch.dryrun import _emit, run_cell

# (tag, kwargs) per variant; kwargs forwarded to run_cell
CELLS = {
    # -- A: qwen3-moe-235b-a22b x train_4k (paper-representative) ----------- #
    "A": ("qwen3-moe-235b-a22b", "train_4k", [
        ("A0_baseline_remat_full", {}),
        ("A1_remat_dots", {"opts_kw": {"remat": "dots"}}),
        ("A2_remat_none", {"opts_kw": {"remat": "none"}}),
        ("A3_attn_bf16", {"opts_kw": {"remat": "dots",
                                      "attn_compute_dtype": "bf16_accum32"}}),
        ("A4_lexi_b050", {"opts_kw": {"remat": "dots",
                                      "attn_compute_dtype": "bf16_accum32"},
                          "lexi_budget_frac": 0.5}),
        ("A5_capacity_1.0", {"opts_kw": {"remat": "dots",
                                         "attn_compute_dtype": "bf16_accum32"},
                             "cfg_overrides": {"moe_capacity_factor": 1.0}}),
        ("A6_a2a_chunks4", {"opts_kw": {"remat": "dots",
                                        "attn_compute_dtype": "bf16_accum32",
                                        "a2a_chunks": 4}}),
        ("A7_fsdp", {"opts_kw": {"remat": "full",
                                 "attn_compute_dtype": "bf16_accum32",
                                 "fsdp_params": True},
                     "cfg_overrides": {"moe_capacity_factor": 1.0}}),
        ("A8_fsdp_lexi_b050", {"opts_kw": {"remat": "full",
                                           "attn_compute_dtype": "bf16_accum32",
                                           "fsdp_params": True},
                               "cfg_overrides": {"moe_capacity_factor": 1.0},
                               "lexi_budget_frac": 0.5}),
        ("A9_fsdp_micro4", {"opts_kw": {"remat": "full",
                                        "attn_compute_dtype": "bf16_accum32",
                                        "fsdp_params": True,
                                        "microbatches": 4},
                            "cfg_overrides": {"moe_capacity_factor": 1.0}}),
        ("A10_fsdp_micro8", {"opts_kw": {"remat": "full",
                                         "attn_compute_dtype": "bf16_accum32",
                                         "fsdp_params": True,
                                         "microbatches": 8},
                             "cfg_overrides": {"moe_capacity_factor": 1.0}}),
        ("A11_fsdp_chunk8", {"opts_kw": {"remat": "full",
                                         "attn_compute_dtype": "bf16_accum32",
                                         "fsdp_params": True,
                                         "remat_chunk": 8},
                             "cfg_overrides": {"moe_capacity_factor": 1.0}}),
        ("A12_fsdp_chunk8_lexi", {"opts_kw": {"remat": "full",
                                              "attn_compute_dtype": "bf16_accum32",
                                              "fsdp_params": True,
                                              "remat_chunk": 8},
                                  "cfg_overrides": {"moe_capacity_factor": 1.0},
                                  "lexi_budget_frac": 0.5}),
    ]),
    # -- B: qwen3-32b x decode_32k (worst roofline fraction at scale) -------- #
    "B": ("qwen3-32b", "decode_32k", [
        ("B0_baseline", {}),
        ("B1_seqshard_kv", {"opts_kw": {"decode_kv_seq_shard": True}}),
        ("B2_seqshard_bf16", {"opts_kw": {"decode_kv_seq_shard": True,
                                          "attn_compute_dtype": "bf16_accum32"}}),
        ("B3_seqshard_bf16_unroll", {"opts_kw": {
            "decode_kv_seq_shard": True,
            "attn_compute_dtype": "bf16_accum32",
            "scan_unroll": True}}),
        ("B4_seqshard_bf16_fsdp", {"opts_kw": {
            "decode_kv_seq_shard": True,
            "attn_compute_dtype": "bf16_accum32",
            "fsdp_params": True}}),
    ]),
    # -- C: h2o-danube-1.8b x long_500k (most collective-bound) -------------- #
    "C": ("h2o-danube-1.8b", "long_500k", [
        ("C0_baseline", {}),
        ("C1_seqshard_kv", {"opts_kw": {"decode_kv_seq_shard": True}}),
        ("C2_seqshard_bf16", {"opts_kw": {"decode_kv_seq_shard": True,
                                          "attn_compute_dtype": "bf16_accum32"}}),
        ("C3_seqshard_bf16_unroll", {"opts_kw": {
            "decode_kv_seq_shard": True,
            "attn_compute_dtype": "bf16_accum32",
            "scan_unroll": True}}),
    ]),
}

#: the reference's ``cell_opts`` levers that act on XLA's lowering alone
XLA_LEVERS = {
    "scan_unroll": "scan_unroll: unrolls the reference's lax.scan over the "
                   "layers; the port runs every layer eagerly, with no scan "
                   "to unroll",
    "act_constraint": "act_constraint: an XLA sharding constraint on the "
                      "activations; the port's ranks hold their blocks "
                      "explicitly, with nothing for a compiler to place",
}


def xla_lever(kw: Dict) -> Optional[str]:
    """The reason a variant's keyword arguments cannot run on the port (the
    first XLA lever set in its ``opts_kw``), or None."""
    opts = kw.get("opts_kw", {})
    return next((why for lever, why in XLA_LEVERS.items()
                 if opts.get(lever)), None)


def run_variant(cell: str, tag: str, out_dir: Optional[str] = None) -> Dict:
    """One variant of ``CELLS[cell]`` -> its record (``run_cell``'s, or a
    ``SKIP`` one for an XLA lever)."""
    arch, shape, variants = CELLS[cell]
    kw = dict(variants)[tag]
    why = xla_lever(kw)
    if why is not None:
        rec = {"arch": arch, "shape": shape, "mesh": "16x16", "tag": tag,
               "status": "SKIP", "reason": why}
        _emit(rec, out_dir, verbose=False)
        return rec
    return run_cell(arch, shape, out_dir=out_dir, tag=tag, verbose=False,
                    **kw)


def summary(rec: Dict) -> str:
    """The variant's one line."""
    if rec["status"] == "OK":
        r = rec["roofline"]
        return (f"  -> {rec['tag']}: OK dom={r['dominant']} "
                f"t=({r['t_compute']:.4e},{r['t_memory']:.4e},"
                f"{r['t_collective']:.4e})s "
                f"frac={r['roofline_fraction']:.4f} "
                f"peak={rec['memory_analysis']['peak_bytes'] / 1e9:.2f}GB "
                f"rank={rec['rank']}")
    if rec["status"] == "SKIP":
        return f"  -> {rec['tag']}: SKIP {rec['reason']}"
    return f"  -> {rec['tag']}: FAIL {rec['error'][:160]}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="all", choices=["A", "B", "C", "all"])
    ap.add_argument("--variant", default=None, help="run a single tag")
    ap.add_argument("--out", default=None,
                    help="directory for one JSON record a variant")
    args = ap.parse_args(argv)
    cells = list(CELLS) if args.cell == "all" else [args.cell]
    tags = [(c, tag) for c in cells for tag, _ in CELLS[c][2]
            if args.variant in (None, tag)]
    if not tags:
        raise SystemExit(f"no variant {args.variant!r} in cells {cells}")
    t0 = time.time()
    status = []
    for c, tag in tags:
        rec = run_variant(c, tag, args.out)
        status.append(rec["status"])
        print(summary(rec), flush=True)
    print(f"\n{len(status)} variants: {status.count('OK')} OK, "
          f"{status.count('SKIP')} SKIP, {status.count('FAIL')} FAIL; "
          f"{time.time() - t0:.1f} s")
    return 1 if "FAIL" in status else 0


if __name__ == "__main__":
    raise SystemExit(main())
