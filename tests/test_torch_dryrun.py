"""The production dry run on ``meta`` (``repro_torch.launch.dryrun``) and
what it rests on: ``models.abstract_caches``, a placed mesh whose
collectives only count, the kernels' ``meta`` route and costs,
``analysis/counters.py`` and ``analysis/roofline.py``; and whisper's
tensor parallelism.

* ``input_specs``, ``applicability``, ``abstract_caches``,
  ``cell_config`` and ``cell_opts`` against the reference's, for the ten
  assigned architectures and the four shapes; the reference's dry-run
  module is imported with ``XLA_FLAGS`` held, so that its import sets no
  device count for this process.
* ``model_flops_for_cell`` and ``analyze_costs`` with the reference's
  ``HW``: the reference's report, field by field.
* Each kernel's cost against a count by hand at one shape; each
  wrapper's ``meta`` route against its plain version's output shapes and
  dtypes.
* olmo-1b ``decode_32k`` at 16 x 16 (the reference's own system-test
  cell) in process.
* A (1, 4) gloo world (``_torch_dryrun_ranks.py``): per rank, a reduced
  OLMoE's train step (EP + TP) and decode step and whisper's train,
  prefill and decode steps give the same FLOPs, aten bytes, collective
  bytes and calls by kind as the same cells on ``meta`` placed on that
  rank; whisper's loss, gradients and logits under tensor parallelism
  match one process to 1e-5 (gradients: 1e-5 of each leaf's largest
  entry) and JAX to ``test_torch_tp.py``'s 2e-4, and its cross-entropy
  stays vocab-parallel (three sums of [B, S], no gather); the OLMoE
  ``ep_a2a`` train step notes its backward's all-to-alls (2x the
  forward's without remat, 3x with), the same on ``meta``.
"""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402

import _torch_dryrun_ranks as ranks  # noqa: E402

SPAWN_TIMEOUT = 300
PORT = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=2e-4, atol=2e-4)
ASSIGNED = ("olmo-1b", "minicpm3-4b", "qwen3-32b", "h2o-danube-1.8b",
            "llama4-scout-17b-a16e", "qwen3-moe-235b-a22b", "pixtral-12b",
            "zamba2-1.2b", "mamba2-780m", "whisper-base")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _reference_dryrun():
    """``repro.launch.dryrun`` without its import-time device count (it
    sets ``XLA_FLAGS`` only where none is set)."""
    old = os.environ.get("XLA_FLAGS")
    os.environ["XLA_FLAGS"] = old or ""
    try:
        import repro.launch.dryrun as ref
    finally:
        if old is None:
            del os.environ["XLA_FLAGS"]
    return ref


def _stacked(port_caches, cfg):
    """The port's per-layer caches stacked as the reference stacks a run
    of identical layers (one leading dim a run of more than one) -> a
    list of {leaf path: (shape, dtype)} per group."""
    from repro_torch.models.blocks import group_pattern
    from repro_torch.tree import flatten_with_paths
    if cfg.is_encoder_decoder:
        groups = [(i, 1) for i in range(cfg.num_layers)]
    else:
        groups = [(g.start, g.count) for g in group_pattern(cfg.pattern())]
    out = []
    for start, n in groups:
        leaves = dict(flatten_with_paths(port_caches[start]))
        for i in range(start, start + n):     # every layer of the run alike
            assert {p: (t.shape, t.dtype) for p, t in
                    flatten_with_paths(port_caches[i])} == {
                p: (t.shape, t.dtype) for p, t in leaves.items()}
        out.append({p: (((n,) if n > 1 else ()) + tuple(t.shape),
                        str(t.dtype).replace("torch.", ""))
                    for p, t in leaves.items()})
    return out


def _ref_leaves(tree):
    import jax
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = (tuple(x.shape), str(x.dtype))
    return out


def _spec_leaves(tree):
    from repro_torch.tree import flatten_with_paths
    return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in flatten_with_paths(tree)}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_applicability_and_caches_match_reference(arch):
    """Every shape: the skip and its reason; the inputs' leaves, shapes
    and dtypes; ``abstract_caches`` leaf for leaf (the port's layers
    stacked as the reference's runs)."""
    from repro.configs import get_config as jget
    from repro.configs.shapes import SHAPE_BY_NAME as JSHAPES
    from repro.configs.shapes import applicability as japp
    from repro import models as jm
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPE_BY_NAME, applicability
    from repro_torch.launch import dryrun
    ref = _reference_dryrun()
    cfg, cfg_j = get_config(arch), jget(arch)
    for name in SHAPES:
        shape, shape_j = SHAPE_BY_NAME[name], JSHAPES[name]
        assert applicability(cfg, shape) == japp(cfg_j, shape_j)
        got = dryrun.input_specs(dryrun.cell_config(cfg, shape), shape)
        want = ref.input_specs(ref.cell_config(cfg_j, shape_j), shape_j)
        if shape.step == "decode":
            got_caches, want_caches = got.pop("caches"), want.pop("caches")
            stacked = _stacked(got_caches, cfg)
            assert len(stacked) == len(want_caches)
            for mine, theirs in zip(stacked, want_caches):
                assert mine == _ref_leaves(theirs), (name, mine)
        assert _spec_leaves(got) == _ref_leaves(want), name
    caches = models.abstract_caches(cfg, 2, 64)
    assert all(t.is_meta for t in __import__(
        "repro_torch.tree", fromlist=["leaves"]).leaves(caches))
    want = jm.abstract_caches(cfg_j, 2, 64)
    for mine, theirs in zip(_stacked(caches, cfg), want):
        assert mine == _ref_leaves(theirs)


def _fields(x):
    import dataclasses
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_cell_config_and_opts_match_reference(arch):
    """Field for field at every shape, plain and at a LExI budget of 0.5
    (the synthetic plan tuple); the options the port has (it has no
    ``scan_unroll`` / ``act_constraint``), where the kernel options are
    off (the port's serving cells then differ in ``use_moe_kernel``
    only)."""
    from repro.configs import get_config as jget
    from repro.configs.shapes import SHAPE_BY_NAME as JSHAPES
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPE_BY_NAME
    from repro_torch.launch import dryrun
    ref = _reference_dryrun()
    for name in SHAPES:
        for frac in (None, 0.5):
            got = dryrun.cell_config(get_config(arch), SHAPE_BY_NAME[name],
                                     frac)
            want = ref.cell_config(jget(arch), JSHAPES[name], frac)
            g, w = _fields(got), _fields(want)
            assert g.keys() == w.keys()
            assert g == w, {k: (g[k], w[k]) for k in g if g[k] != w[k]}
            assert got.lexi_plan == want.lexi_plan
            if frac is not None and got.is_moe and got.moe_top_k > 1:
                assert got.lexi_plan is not None
            mine = _fields(dryrun.cell_opts(got, SHAPE_BY_NAME[name]))
            theirs = _fields(ref.cell_opts(want, JSHAPES[name]))
            assert mine.pop("use_moe_kernel") == (
                got.is_moe and SHAPE_BY_NAME[name].step != "train")
            for k, v in mine.items():
                if k in theirs:
                    assert v == theirs[k], (name, k)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_roofline_matches_reference_with_its_hw(arch):
    """``model_flops_for_cell`` at every shape, and ``analyze_costs`` run
    with the reference's ``HW`` on the same costs: the reference's report,
    field by field, and its JSON (``bound_time_s``,
    ``roofline_fraction``)."""
    from repro.analysis import roofline as jrl
    from repro.configs import get_config as jget
    from repro.configs.shapes import SHAPE_BY_NAME as JSHAPES
    from repro_torch.analysis import roofline as rl
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPE_BY_NAME
    for i, name in enumerate(SHAPES):
        cfg, cfg_j = get_config(arch), jget(arch)
        shape, shape_j = SHAPE_BY_NAME[name], JSHAPES[name]
        assert rl.model_flops_for_cell(cfg, shape) == \
            jrl.model_flops_for_cell(cfg_j, shape_j)
        coll = {"all-reduce": 3e9 * (i + 1), "all-to-all": 1e8 / (i + 1)}
        args = (1.5e13 * (i + 1), 4e11 / (i + 1), coll)
        kw = dict(chips=256, mesh_desc="16x16", bytes_per_device=5e10,
                  note="n")
        got = rl.analyze_costs(rl.CellCosts(*args), cfg, shape,
                               hw=jrl.HW, **kw)
        want = jrl.analyze_costs(jrl.CellCosts(*args), cfg_j, shape_j, **kw)
        mine = got.to_json()
        for k, v in want.to_json().items():
            assert mine[k] == v, (name, k, mine[k], v)
        d = rl.CellCosts(*args) - rl.CellCosts(1.0, 2.0, {"all-reduce": 1.0})
        dj = jrl.CellCosts(*args) - jrl.CellCosts(1.0, 2.0,
                                                  {"all-reduce": 1.0})
        assert _fields(d) == _fields(dj)
        assert _fields(d.scaled_add(d, 3)) == _fields(dj.scaled_add(dj, 3))


def test_roofline_hw_is_the_h100s():
    from repro_torch.analysis import roofline as rl
    assert rl.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                     "link_bw": 450e9}


# --------------------------------------------------------------------------- #
# Kernels on meta: costs by hand, outputs like the plain versions'
# --------------------------------------------------------------------------- #


def _kernel_cases():
    """name -> (wrapper call on a device, plain call, cost by hand)."""
    import importlib
    from repro_torch import kernels as K
    fa_mod, fd_mod, fdp_mod, md_mod, mf_mod, mg_mod = (
        importlib.import_module(f"repro_torch.kernels.{m}") for m in (
            "flash_attention", "flash_decode", "flash_decode_paged",
            "moe_decode", "moe_ffn", "moe_gmm"))
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    b, hq, hkv, s, hd = 2, 4, 2, 8, 64
    e, d, f, k, m, bm = 4, 64, 32, 2, 16, 8
    n, p, nb, r, dr = 6, 4, 3, 512, 64

    def t(shape, dtype, dev):
        if dtype == i32:
            return torch.zeros(shape, dtype=dtype, device=dev)
        return torch.ones(shape, dtype=dtype, device=dev)

    def int8(shape, dev):
        return torch.zeros(shape, dtype=torch.int8, device=dev)

    out = {
        "flash_attention": (
            lambda dv: ((t((b, hq, s, hd), bf, dv), t((b, hkv, s, hd), bf, dv),
                         t((b, hkv, s, hd), bf, dv)), {"window": 3}),
            K.flash_attention, fa_mod.flash_attention_plain,
            # pairs of s = 8 under a window of 3: 1 + 2 + 3 * 6 = 21
            (4 * b * hq * hd * 21,
             2 * (2 * b * hq * s * hd + 2 * b * hkv * s * hd))),
        "flash_decode": (
            lambda dv: ((t((b, hq, hd), bf, dv), t((b, s, hkv, hd), bf, dv),
                         t((b, s, hkv, hd), bf, dv), t((b, s), i32, dv),
                         t((b,), i32, dv)), {}),
            K.flash_decode, fd_mod.flash_decode_plain,
            (4 * b * s * hq * hd,
             2 * 2 * b * hq * hd + 2 * 2 * b * s * hkv * hd + 4 * b * s
             + 4 * b)),
        "flash_decode_paged": (
            lambda dv: ((t((b, hq, hd), bf, dv), t((n, p, hkv, hd), bf, dv),
                         t((n, p, hkv, hd), bf, dv), t((n, p), i32, dv),
                         t((b, nb), i32, dv), t((b,), i32, dv)), {}),
            K.flash_decode_paged, fdp_mod.flash_decode_paged_plain,
            (4 * b * nb * p * hq * hd,
             2 * 2 * b * hq * hd + b * nb * p * (2 * 2 * hkv * hd + 4)
             + 4 * b * nb + 4 * b)),
        "flash_decode_paged_mla": (
            lambda dv: ((t((b, hq, r), f32, dv), t((b, hq, dr), f32, dv),
                         t((n, p, r), bf, dv), t((n, p, dr), bf, dv),
                         t((n, p), i32, dv), t((b, nb), i32, dv),
                         t((b,), i32, dv)), {"scale": 0.1}),
            K.flash_decode_paged_mla, fdp_mod.flash_decode_paged_mla_plain,
            (b * nb * p * hq * (2 * (r + dr) + 2 * r),
             2 * 4 * b * hq * r + 4 * b * hq * dr
             + b * nb * p * (2 * (r + dr) + 4) + 4 * b * nb + 4 * b)),
        "moe_ffn": (
            lambda dv: ((t((e, m, d), bf, dv), t((e, d, 2 * f), bf, dv),
                         t((e, f, d), bf, dv)), {}),
            K.moe_ffn, mf_mod.moe_ffn_plain,
            (e * m * 6 * d * f, 2 * (2 * e * m * d + 3 * e * d * f))),
        "moe_gmm": (
            lambda dv: ((t((m, d), bf, dv), t((e, d, 2 * f), bf, dv),
                         t((e, f, d), bf, dv), t((m // bm,), i32, dv),
                         t((m // bm,), i32, dv)), {"block_m": bm}),
            K.moe_gmm, mg_mod.moe_gmm_plain,
            # 2 tiles: at most 2 of the 4 experts
            (m * 6 * d * f, 2 * 2 * m * d + 2 * 3 * d * f * 2 + 2 * 2 * 4)),
        "moe_decode": (
            lambda dv: ((t((b, d), bf, dv), t((e, d, 2 * f), bf, dv),
                         t((e, f, d), bf, dv), t((b, k), i32, dv),
                         t((b, k), f32, dv)), {}),
            K.moe_decode, md_mod.moe_decode_plain,
            # 4 slots: at most the 4 experts
            (b * k * 6 * d * f, 2 * 2 * b * d + 4 * 3 * d * f * 2
             + b * k * 8)),
        "moe_gmm_quant": (
            lambda dv: ((t((m, d), bf, dv), int8((e, d, 2 * f), dv),
                         int8((e, f, d), dv), t((e, 2, f), f32, dv),
                         t((e, f), f32, dv), t((m // bm,), i32, dv),
                         t((m // bm,), i32, dv)),
                        {"dtype": "int8", "block_m": bm}),
            K.moe_gmm_quant, mg_mod.moe_gmm_quant_plain,
            (m * 6 * d * f, 2 * 2 * m * d + 2 * (3 * d * f + 3 * f * 4)
             + 2 * 2 * 4)),
        "moe_decode_quant": (
            lambda dv: ((t((b, d), bf, dv), int8((e, d, 2 * f), dv),
                         int8((e, f, d), dv), t((e, 2, f), f32, dv),
                         t((e, f), f32, dv), t((b, k), i32, dv),
                         t((b, k), f32, dv)), {"dtype": "int8"}),
            K.moe_decode_quant, md_mod.moe_decode_quant_plain,
            (b * k * 6 * d * f, 2 * 2 * b * d + 4 * (3 * d * f + 3 * f * 4)
             + b * k * 8)),
    }
    return out


KERNELS = ("flash_attention", "flash_decode", "flash_decode_paged",
           "flash_decode_paged_mla", "moe_ffn", "moe_gmm", "moe_decode",
           "moe_gmm_quant", "moe_decode_quant")


def _plain(name, fn, args, kw):
    if name in ("moe_gmm", "moe_gmm_quant"):
        kw = dict(kw)
        bm = kw.pop("block_m")
        return fn(*args, bm, **kw)
    return fn(*args, **kw)


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_meta_route_reports_the_cost_by_hand(name):
    """On ``meta`` the wrapper checks its arguments, returns an empty
    output shaped as its plain version's, launches nothing and reports
    one call of the launch's cost (counted by hand above) to the
    counters; the CPU route reports nothing."""
    from repro_torch import kernels as K
    from repro_torch.analysis.counters import count
    make, wrapper, plain, (flops, nbytes) = _kernel_cases()[name]
    args, kw = make("meta")
    before = K.launch_counts()
    with count() as c:
        got = wrapper(*args, **kw)
    assert K.launch_counts() == before
    assert got.is_meta
    assert c.kernel_calls == {name: 1}
    assert (c.kernel_flops, c.kernel_bytes) == (flops, nbytes)
    assert c.aten_bytes == 0 and c.aten_flops == 0
    cargs, ckw = make("cpu")
    want = _plain(name, plain, cargs, ckw)
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    with count() as c:
        wrapper(*cargs, **ckw)
    assert c.kernel_calls == {} and c.aten_bytes > 0


def test_kernel_meta_route_checks_as_on_the_card():
    """The card route's checks run on ``meta``: a dtype the kernel does
    not take is refused there too."""
    from repro_torch import kernels as K
    q = torch.empty((2, 4, 8, 80 + 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.flash_attention(q, q[:, :2], q[:, :2])
    x = torch.empty((4, 8, 64), device="meta")             # f32, not bf16
    w1 = torch.empty((4, 64, 64), dtype=torch.bfloat16, device="meta")
    w2 = torch.empty((4, 32, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(TypeError, match="bfloat16"):
        K.moe_ffn(x, w1, w2)


# --------------------------------------------------------------------------- #
# Placed meshes and the counters
# --------------------------------------------------------------------------- #


def test_placed_mesh_is_no_world():
    """A placed mesh has the rank's coordinates and no process group; it
    is not bound, so the runner and the engine refuse it."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.serving.runner import ModelRunner
    mesh = make_production_mesh(multi_pod=True).place(37)
    assert not mesh.bound and mesh.placed
    assert mesh.coordinates() == (0, 2, 5) and mesh.rank == 37
    assert mesh.axis_index("model") == 5
    assert mesh.axis_index(("pod", "data")) == 2
    assert mesh.axis_size(("pod", "data")) == 32
    assert mesh.get_group("model") is None
    with pytest.raises(ValueError, match="bound mesh"):
        ModelRunner(None, {}, mesh=mesh, graphs=False)


def test_placed_collectives_count_and_compute_nothing():
    """Each collective notes what the bound path notes (kind, result
    bytes, group size) and returns an empty tensor of its result's shape;
    the Megatron operators count both ways, and their aten work counts as
    the collective's, not as HBM bytes."""
    from repro_torch.analysis.counters import count
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import comm
    mesh = make_test_mesh((2, 4)).place(5)
    x = torch.empty((4, 6), device="meta", requires_grad=True)
    with count() as c:
        assert comm.all_to_all(x, mesh, "model").shape == (4, 6)
        assert comm.all_gather(x, mesh, "model", dim=1).shape == (4, 24)
        assert comm.reduce_scatter(x, mesh, "model", dim=0).shape == (1, 6)
        assert comm.pmax(x, mesh, "data").shape == (4, 6)
        y = comm.reduce_from_model(comm.copy_to_model(x, mesh), mesh)
        comm.gather_from_model(y, mesh, 1).sum().backward()
        comm.barrier(mesh)
    n = 4 * 6 * 4
    assert c.collectives.bytes_by_kind == {
        "all-to-all": n, "all-gather": n + n, "reduce-scatter": n,
        "all-reduce": n + n + n}
    assert c.collectives.count_by_kind == {
        "all-to-all": 1, "all-gather": 2, "reduce-scatter": 1,
        "all-reduce": 3}
    assert x.grad.shape == x.shape
    # the sum of the gathered [4, 24] (in, out), the backward's seed
    # (ones_like: in, out), gather_from_model's backward keeping the rank's
    # block (a copy: in, out); none of the collectives' own copies
    assert c.aten_bytes == (4 * n + 4) + (4 + 4) + 2 * n


def test_placed_backward_notes_what_the_bound_backward_runs():
    """The backward of ``all_to_all``, ``psum`` and ``pmean`` is the
    module's own collective on the gradient: on a placed mesh it notes
    an all-to-all or an all-reduce of the gradient's bytes, as the bound
    one does, and its copies count as the collective's."""
    from repro_torch.analysis.counters import count
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import comm
    mesh = make_test_mesh((2, 4)).place(5)
    x = torch.empty((4, 6), device="meta", requires_grad=True)
    with count() as c:
        y = comm.all_to_all(x, mesh, "model")
        z = comm.pmean(comm.psum(y, mesh, "data"), mesh, "model")
        z.sum().backward()
    n = 4 * 6 * 4
    assert c.collectives.count_by_kind == {"all-to-all": 2, "all-reduce": 4}
    assert c.collectives.bytes_by_kind == {"all-to-all": 2 * n,
                                           "all-reduce": 4 * n}
    assert x.grad.shape == x.shape
    # the mean's division (in, out) both ways, the sum (in, out) and the
    # backward's seed (in, out): none of the collectives' own copies
    assert c.aten_bytes == 2 * (n + n) + (n + 4) + (4 + 4)


def test_counters_track_the_peak_of_live_storages():
    """The peak is the most bytes held at once: inputs, then what the step
    allocates, each freed when its last reference dies."""
    from repro_torch.analysis.counters import count
    a = torch.empty((1024,), device="meta")                 # 4 KiB input
    with count(a) as c:
        b = a * 2                                          # + 4 KiB
        del b
        d = torch.cat([a, a])                              # + 8 KiB
        e = d[:10]                                          # a view
        del d, e
    assert c.input_bytes == 4096
    assert c.peak_bytes == 4096 + 8192
    assert c.aten_bytes == 2 * 4096 + 4 * 4096      # mul, cat: in, out


def test_heaviest_model_rank_finds_the_ranks_with_more_heads():
    """A column block that cuts 3 heads over 4 ranks gives ranks 1 and 2
    two heads each, ranks 0 and 3 one: the dry run also runs rank 1.
    minicpm3's 40 MLA heads over 16 give every rank 3: rank 0 alone."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import heaviest_model_rank
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    cfg = get_config("qwen3-moe-235b-a22b").reduced().with_(
        num_heads=3, num_kv_heads=1, head_dim=32)
    assert heaviest_model_rank(cfg, make_test_mesh((1, 4))) == 1
    assert heaviest_model_rank(get_config("minicpm3-4b"),
                               make_production_mesh()) == 0


def test_olmo_decode_32k_cell_at_16x16():
    """The reference's own system-test cell, in process: OK, the parameter
    bytes those of the rank's blocks, collectives counted, the H100's
    terms."""
    from repro_torch import models
    from repro_torch.analysis.roofline import HW
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import local_params
    from repro_torch.tree import leaves
    rec = dryrun.run_cell("olmo-1b", "decode_32k", verbose=False)
    assert rec["status"] == "OK", rec.get("traceback")
    cfg = get_config("olmo-1b")
    mesh = make_production_mesh().place(0)
    blocks = local_params(models.abstract_params(cfg), cfg, mesh)
    assert rec["param_bytes"] == sum(t.numel() * t.element_size()
                                     for t in leaves(blocks))
    r = rec["roofline"]
    assert r["collective_bytes"] > 0 and r["chips"] == 256
    assert r["t_memory"] == r["hlo_bytes"] / HW["hbm_bw"]
    assert r["t_collective"] == r["collective_bytes"] / HW["link_bw"]
    assert rec["memory_analysis"]["peak_bytes"] >= rec["param_bytes"]


def test_mla_decode_cell_under_seq_shard_counts_as_without():
    """C9: an MLA model's decode cell under ``decode_kv_seq_shard`` runs
    (it raised before) and counts what it counts without the flag: the
    port keeps an MLA model's ``pos`` whole (``local_cache_specs``), so no
    collective gathers it and every rank holds the whole latent cache, as
    the reference's partitioned program does after GSPMD's gather."""
    from repro_torch.launch import dryrun
    recs = [dryrun.run_cell("minicpm3-4b", "decode_32k", verbose=False,
                            opts_kw={"decode_kv_seq_shard": flag})
            for flag in (False, True)]
    for rec in recs:
        assert rec["status"] == "OK", rec.get("traceback")
    assert recs[1]["counts"] == recs[0]["counts"]
    assert recs[1]["memory_analysis"] == recs[0]["memory_analysis"]
    assert recs[1]["roofline"]["collective_bytes"] > 0


# --------------------------------------------------------------------------- #
# The (1, 4) gloo world: real counts against meta, whisper's TP
# --------------------------------------------------------------------------- #


def _join(ctx, timeout):
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the four ranks ran past {timeout} s")


def _whisper_one_process():
    from repro_torch import models
    from repro_torch.training import value_and_grad
    cfg = ranks.cells()["whisper_train"][0]
    params = models.init_params(cfg, 0, device="cpu")
    b = ranks.whisper_batch(cfg)
    loss, m = models.loss_fn(params, cfg, b)
    _, _, grads = value_and_grad(cfg)(params, b)
    return {"loss": torch.stack([loss, m["xent"], m["aux"]]).detach(),
            "grads": grads, "logits": ranks.whisper_steps(params, cfg),
            "params": params}


def _whisper_jax(params):
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro.configs import get_config as jget
    from _torch_ref import reference_params
    cfg = ranks.cells()["whisper_train"][0]
    cfg_j = jget("whisper-base").reduced().with_(num_layers=2)
    pj = reference_params(params, cfg)
    b = {k: jnp.asarray(v.numpy())
         for k, v in ranks.whisper_batch(cfg).items()}
    _, m = jax.jit(lambda p, bb: jm.loss_fn(p, cfg_j, bb))(pj, b)
    bsz, s = b["tokens"].shape
    caches = jm.init_caches(cfg_j, bsz, s + ranks.DECODE_STEPS)
    lg, caches = jm.prefill_fn(pj, cfg_j, {"frames": b["frames"],
                                           "tokens": b["tokens"]}, caches)
    seq = [np.asarray(lg)]
    step = jax.jit(lambda p, t, po, c: jm.decode_fn(p, cfg_j, t, po, c))
    pos = jnp.full((bsz,), s, jnp.int32)
    for i in range(ranks.DECODE_STEPS):
        nxt = jnp.argmax(jnp.asarray(seq[-1]), -1).astype(jnp.int32)
        lg, caches = step(pj, nxt, pos + i, caches)
        seq.append(np.asarray(lg))
    return {"xent": float(m["xent"]), "logits": seq}


def _meta_counts():
    """rank -> tag -> the cell's counts on ``meta``, the mesh placed; and
    under "a2a" the rank's ``a2a_steps`` there."""
    from repro_torch.launch.mesh import make_test_mesh
    out = {}
    for r in range(ranks.WORLD):
        mesh = make_test_mesh(ranks.SHAPE, ranks.AXES).place(r)
        out[r] = {tag: ranks.counted(cfg, shape, mesh, "meta")
                  for tag, (cfg, shape) in ranks.cells().items()}
        out[r]["a2a"] = ranks.a2a_steps(mesh, "meta")
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("dryrun_world")
    ctx = mp.start_processes(ranks.run, args=(str(d / "rdv"), str(d)),
                             nprocs=ranks.WORLD, join=False,
                             start_method="spawn")
    try:
        meta = _meta_counts()
        one = _whisper_one_process()
        one["jax"] = _whisper_jax(one["params"])
    finally:
        _join(ctx, SPAWN_TIMEOUT)
    got = {r: torch.load(str(d / f"rank{r}.pt"), weights_only=False)
           for r in range(ranks.WORLD)}
    return got, meta, one


CELL_TAGS = list(ranks.cells())


@pytest.mark.parametrize("tag", CELL_TAGS)
def test_meta_counts_equal_the_gloo_ranks(world, tag):
    """Per rank: FLOPs, aten bytes, collective bytes and calls by kind of
    the real step on the gloo mesh equal the same step's on ``meta``."""
    got, meta, _ = world
    for r in range(ranks.WORLD):
        real, dry = got[r]["counts"][tag], meta[r][tag]
        assert real == dry, (r, {k: (real[k], dry[k]) for k in real
                                 if real[k] != dry[k]})
        assert real["flops"] > 0 and real["bytes"] > 0
        assert sum(real["collective_calls"].values()) > 0


@pytest.mark.parametrize("remat", ranks.A2A_REMATS)
def test_train_step_notes_the_backward_all_to_alls(world, remat):
    """C4: per rank, the ``ep_a2a`` train step's all-to-all calls and bytes
    are 2x (remat off: forward, backward) or 3x (on: forward, the rerun,
    backward) its no-grad forward's, two a MoE layer (dispatch,
    combine), and every collective of both equal on ``meta``."""
    got, meta, _ = world
    cfg = ranks.cells()["olmoe_train"][0]
    times = {"none": 2, "full": 3}[remat]
    for r in range(ranks.WORLD):
        real, dry = got[r]["a2a"][remat], meta[r]["a2a"][remat]
        assert real == dry, (r, real, dry)
        calls, nbytes = real["forward"]["all-to-all"]
        assert calls == 2 * cfg.num_moe_layers
        assert real["step"]["all-to-all"] == (times * calls, times * nbytes)


def test_whisper_loss_stays_vocab_parallel(world):
    """C6: whisper's cross-entropy under tensor parallelism notes three
    all-reduces of [B, S] f32 (the blocks' max, the exp sum, the gold
    logit) and gathers nothing."""
    got, _, _ = world
    assert got[0]["whisper"]["xent_notes"] == {
        "all-reduce": (3, 3 * ranks.BATCH * ranks.SEQ * 4)}


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def test_whisper_tp_loss_matches_one_process_and_reference(world):
    got, _, one = world
    _close(got[0]["whisper"]["loss"], one["loss"], **PORT)
    _close(got[0]["whisper"]["loss"][1], one["jax"]["xent"], **JAX_TOL)


def test_whisper_tp_grads_match_one_process(world):
    from repro_torch.tree import flatten_with_paths
    got, _, one = world
    mine = dict(flatten_with_paths(got[0]["whisper"]["grads"]))
    want = dict(flatten_with_paths(one["grads"]))
    assert sorted(mine) == sorted(want)
    for path, w in want.items():
        assert mine[path].shape == w.shape, path
        _close(mine[path], w, rtol=0,
               atol=1e-5 * float(w.abs().max()) + 1e-12)


def test_whisper_tp_logits_match_one_process_and_reference(world):
    got, _, one = world
    for mine, want, ref in zip(got[0]["whisper"]["logits"], one["logits"],
                               one["jax"]["logits"]):
        _close(mine, want, **PORT)
        _close(mine, ref, **JAX_TOL)


def test_whisper_on_one_rank_is_the_no_mesh_path_bit_for_bit(world):
    """At one rank every collective copies and every block is whole: the
    loss and the prefill and decode logits are the no-mesh path's bits (a
    one-rank gloo world in this process); the gradients sum their
    contributions in another order (``f``'s backward collects a layer
    input's before it joins the residual's), within 1e-6 of each leaf's
    largest entry."""
    import tempfile
    import torch.distributed as dist
    from repro_torch import models
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.training import value_and_grad
    from repro_torch.tree import leaves
    _, _, one = world
    cfg = ranks.cells()["whisper_train"][0]
    b = ranks.whisper_batch(cfg)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/rdv",
                                rank=0, world_size=1)
        try:
            mesh = make_test_mesh((1, 1)).bind(device="cpu")
            params = one["params"]
            loss, m = models.loss_fn(params, cfg, b, mesh=mesh)
            _, _, grads = value_and_grad(cfg, mesh=mesh)(params, b)
            logits = ranks.whisper_steps(params, cfg, mesh)
        finally:
            dist.destroy_process_group()
    assert torch.equal(torch.stack([loss, m["xent"], m["aux"]]).detach(),
                       one["loss"])
    assert all(torch.equal(g, w) for g, w in zip(logits, one["logits"]))
    for g, w in zip(leaves(grads), leaves(one["grads"])):
        _close(g, w, rtol=0, atol=1e-6 * float(w.abs().max()) + 1e-12)
