"""The §Perf hillclimb on the port (``repro_torch.launch.hillclimb``)
against the reference's ``experiments/perf/hillclimb.py``.

* ``CELLS`` equals the reference's table, read with ``ast.literal_eval``
  from its source (importing it would set ``XLA_FLAGS`` for 512 devices
  in this process); the variants that ask for an XLA lever (B3 and C3:
  ``scan_unroll``) come out ``SKIP`` with that reason, unrun.
* Every B and C variant on ``meta`` at full depth: ``OK`` or that
  ``SKIP``, and the levers move the counts the reference's way:
  ``decode_kv_seq_shard`` lowers the peak and the memory term,
  ``"bf16_accum32"`` the memory term, FSDP the peak.
* A0, A1, A3, A7 and A9 cut to 4 layers (``cfg_overrides``): A3's memory
  term below A1's (C11: before the repair the bf16 scores' casts counted
  0.4053 s against 0.3914), and A9's peak below A7's, below A0's.
* The command line: one line a variant, a record under ``--out``.
"""

import ast
import json
import os

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402

REFERENCE = os.path.join(os.path.dirname(__file__), "..", "experiments",
                         "perf", "hillclimb.py")
#: the variants that ask for an XLA lever, and the lever
XLA_TAGS = {"B3_seqshard_bf16_unroll": "scan_unroll",
            "C3_seqshard_bf16_unroll": "scan_unroll"}
#: the train cell's variants run cut to this depth
A_TAGS = ("A0_baseline_remat_full", "A1_remat_dots", "A3_attn_bf16",
          "A7_fsdp", "A9_fsdp_micro4")
A_LAYERS = 4


def _reference_cells():
    with open(REFERENCE) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and [getattr(t, "id", None) for t in node.targets]
                == ["CELLS"]):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no CELLS assignment in {REFERENCE}")


def _tags(cells):
    return [tag for c in cells for tag, _ in _hc().CELLS[c][2]]


def _hc():
    from repro_torch.launch import hillclimb
    return hillclimb


@pytest.fixture(scope="module")
def served():
    """Every B and C variant's record, full depth."""
    hc = _hc()
    return {tag: hc.run_variant(tag[0], tag) for tag in _tags("BC")}


@pytest.fixture(scope="module")
def trained():
    """A_TAGS' records at A_LAYERS layers: each variant's arguments, its
    config overrides plus the depth, through ``run_cell``."""
    from repro_torch.launch.dryrun import run_cell
    arch, shape, variants = _hc().CELLS["A"]
    out = {}
    for tag in A_TAGS:
        kw = dict(dict(variants)[tag])
        kw["cfg_overrides"] = {**kw.get("cfg_overrides", {}),
                               "num_layers": A_LAYERS}
        out[tag] = run_cell(arch, shape, tag=tag, verbose=False, **kw)
    return out


def _term(rec, key="t_memory"):
    return rec["roofline"][key]


def _peak(rec):
    return rec["memory_analysis"]["peak_bytes"]


def test_cells_are_the_references():
    hc = _hc()
    assert hc.CELLS == _reference_cells()
    assert sum(len(v) for _, _, v in hc.CELLS.values()) == 22
    for c, (_, _, variants) in hc.CELLS.items():
        for tag, kw in variants:
            why = hc.xla_lever(kw)
            if tag in XLA_TAGS:
                assert why is not None and why.startswith(XLA_TAGS[tag])
            else:
                assert why is None, (tag, why)


@pytest.mark.parametrize("tag", _tags("BC"))
def test_serving_variant_runs(served, tag):
    rec = served[tag]
    if tag in XLA_TAGS:
        assert rec["status"] == "SKIP"
        assert rec["reason"].startswith(XLA_TAGS[tag])
        assert "roofline" not in rec
    else:
        assert rec["status"] == "OK", rec.get("error")
        assert rec["tag"] == tag and rec["mesh"] == "16x16"


@pytest.mark.parametrize("cell", ["B", "C"])
def test_serving_levers_move_the_counts(served, cell):
    """Each lever the reference's way: the sequence-sharded cache lowers
    the peak and the memory term (x1 against x0), f32 products of the bf16
    cache lower the memory term (x2 against x1)."""
    got = {tag[:2]: rec for tag, rec in served.items() if tag[0] == cell}
    base, seq, bf16 = got[f"{cell}0"], got[f"{cell}1"], got[f"{cell}2"]
    assert _peak(seq) < _peak(base)
    assert _term(seq) < _term(base)
    assert _term(bf16) < _term(seq)


def test_fsdp_lowers_the_decode_peak(served):
    assert _peak(served["B4_seqshard_bf16_fsdp"]) < _peak(
        served["B2_seqshard_bf16"])


def test_train_variants_run(trained):
    for tag, rec in trained.items():
        assert rec["status"] == "OK", (tag, rec.get("error"))


def test_bf16_accum32_lowers_the_train_memory_term(trained):
    """C11's count: A3 (A1 plus ``"bf16_accum32"``) below A1."""
    assert _term(trained["A3_attn_bf16"]) < _term(trained["A1_remat_dots"])


def test_fsdp_and_microbatches_lower_the_train_peak(trained):
    a0, a7, a9 = (_peak(trained[t]) for t in
                  ("A0_baseline_remat_full", "A7_fsdp", "A9_fsdp_micro4"))
    assert a9 < a7 < a0


def test_command_line(tmp_path, capsys):
    """A variant's line, and its record under ``--out`` (a SKIP one: the
    variant is not run)."""
    hc = _hc()
    tag = "C3_seqshard_bf16_unroll"
    assert hc.main(["--cell", "C", "--variant", tag,
                    "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"-> {tag}: SKIP scan_unroll" in out
    assert "1 variants: 0 OK, 1 SKIP, 0 FAIL" in out
    (path,) = tmp_path.iterdir()
    assert json.loads(path.read_text())["status"] == "SKIP"
    with pytest.raises(SystemExit):
        hc.main(["--cell", "A", "--variant", tag])
