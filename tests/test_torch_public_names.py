"""The reference's public names that the port adds late (ROADMAP A15),
each against its counterpart: ``core.lexi_config``, ``serving.sample``,
``models.moe.register_impl`` / ``available_impls``,
``models.common.count_params``, ``models.make_train_batch`` (a
``torch.Generator`` in place of the key), ``models.attention.is_paged``;
and the examples' launchers ``launch/quickstart.py`` and
``launch/lexi_optimize.py`` on ``--device cpu``.

Signature parity, one case a module pair: every public function and
class of a reference module against its counterpart in the port, by
``ast`` (no import: the reference's dry run sets the device count when it
is imported) -- each reference parameter present with the same default
(``jnp`` dtypes read as ``torch``'s), the required positional ones in the
same order, and every parameter the port adds with a default.  Each
divergence left carries its reason in ``EXEMPT``; a default that changes
a result is repaired, never exempted."""

import ast
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402


@pytest.fixture(scope="module")
def setup():
    import jax
    from repro import models as jm
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    from repro_torch.convert import convert_params
    cfg_j = jget("olmoe-1b-7b").reduced()
    cfg_t = tget("olmoe-1b-7b").reduced()
    pj = jax.jit(lambda k: jm.init_params(k, cfg_j))(jax.random.PRNGKey(0))
    pt = convert_params(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


def test_lexi_config_matches_reference(setup):
    from dataclasses import astuple
    from repro.core import lexi_config as jlexi
    from repro.core.sensitivity import SensitivityTable as JTable
    from repro_torch.core import SensitivityTable, lexi_config
    cfg_j, cfg_t, pj, pt = setup
    values = np.random.default_rng(0).random(
        (cfg_t.num_moe_layers, cfg_t.moe_top_k)) * [[3.0, 0.0]]
    kw = dict(arch=cfg_t.name, k_base=cfg_t.moe_top_k,
              moe_layer_indices=tuple(range(cfg_t.num_layers)),
              target_topks=tuple(range(1, cfg_t.moe_top_k + 1)), n_iter=1,
              values=values)
    budget = cfg_t.num_moe_layers * cfg_t.moe_top_k * 3 // 4
    want = jlexi(pj, cfg_j, budget, method="dp", table=JTable(**kw))
    got = lexi_config(pt, cfg_t, budget, method="dp",
                      table=SensitivityTable(**kw), device="cpu")
    assert got.lexi_plan == want.lexi_plan and got.lexi_plan is not None
    as_t = lambda c: [astuple(b) for b in c.pattern()]
    assert as_t(got) == as_t(want)


def test_sample_matches_reference():
    import jax
    import jax.numpy as jnp
    from repro.serving import sample as jsample
    from repro_torch.serving import sample
    logits = np.random.default_rng(1).standard_normal((6, 50)).astype(
        np.float32)
    logits[2, [3, 7]] = 9.0                      # a tie: the first index
    want = np.asarray(jsample(jnp.asarray(logits), jax.random.PRNGKey(0)))
    got = sample(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # top-k at a temperature: every draw lies in the reference's support
    # (the two generators give other numbers from one seed)
    top3 = np.argsort(-logits, axis=1)[:, :3]
    gen = torch.Generator().manual_seed(0)
    for i in range(20):
        g = sample(torch.from_numpy(logits), gen, temperature=0.7, top_k=3)
        w = np.asarray(jsample(jnp.asarray(logits), jax.random.PRNGKey(i),
                               temperature=0.7, top_k=3))
        for row in range(6):
            assert g[row].item() in top3[row] and w[row] in top3[row]


def test_register_impl_and_available_impls_match_reference(setup):
    from repro.models.moe import registry as jreg
    from repro_torch.models.moe import available_impls, moe, register_impl
    from repro_torch.models.moe import registry as treg
    assert available_impls() == jreg.available_impls()
    calls = []

    @register_impl("doubled_dense")
    def doubled(params, cfg, x2d, top_k, use_kernel=False, **kw):
        calls.append(top_k)
        y, aux = treg._dense(params, cfg, x2d, top_k, use_kernel, **kw)
        return 2 * y, aux
    jreg.register_impl("doubled_dense")(lambda *a, **kw: None)
    try:
        assert "doubled_dense" in available_impls()
        assert "doubled_dense" in jreg.available_impls()
        _, cfg_t, _, pt = setup
        x = torch.randn(1, 4, cfg_t.d_model, generator=torch.Generator()
                        .manual_seed(0))
        lp = pt["layers"][0]["moe"]
        y, _ = moe(lp, cfg_t, x, cfg_t.moe_top_k, impl="doubled_dense")
        y0, _ = moe(lp, cfg_t, x, cfg_t.moe_top_k, impl="dense")
        assert calls == [cfg_t.moe_top_k] and torch.equal(y, 2 * y0)
        # an impl that needs a mesh registers, and with no mesh ``moe``
        # runs ``dense`` in its place, as the reference's
        register_impl("needs_a_mesh", needs_mesh=True)(doubled)
        assert "needs_a_mesh" in available_impls()
        y1, _ = moe(lp, cfg_t, x, cfg_t.moe_top_k, impl="needs_a_mesh")
        assert calls == [cfg_t.moe_top_k] and torch.equal(y1, y0)
    finally:
        for name in ("doubled_dense", "needs_a_mesh"):
            treg._IMPLS.pop(name, None)
        jreg._IMPLS.pop("doubled_dense", None)


def test_count_params_matches_reference(setup):
    from repro.models.common import count_params as jcount
    from repro_torch.models.common import count_params
    cfg_j, cfg_t, pj, pt = setup
    assert count_params(pt) == jcount(pj) > 0


def test_make_train_batch_matches_reference(setup):
    import jax
    from repro import models as jm
    from repro_torch import models as tm
    cfg_j, cfg_t, pj, pt = setup
    want = jm.make_train_batch(cfg_j, jax.random.PRNGKey(1), 2, 12)
    got = tm.make_train_batch(cfg_t, torch.Generator().manual_seed(1), 2, 12,
                              device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    for k in ("tokens", "targets"):
        assert 0 <= int(got[k].min()) and int(got[k].max()) < cfg_t.vocab_size
    assert bool((got["mask"] == 1).all())
    loss, _ = tm.loss_fn(pt, cfg_t, got)
    assert np.isfinite(loss.item())


def test_is_paged_matches_reference(setup):
    from repro import models as jm
    from repro.models.attention import is_paged as jpaged
    from repro_torch import models as tm
    from repro_torch.models.attention import is_paged
    cfg_j, cfg_t, _, _ = setup
    for layout in ("paged", "contiguous"):
        cj = jm.init_caches(cfg_j, 2, 32, layout=layout, page_size=16,
                            num_pages=5)
        ct = tm.init_caches(cfg_t, 2, 32, layout=layout, page_size=16,
                            num_pages=5, device="cpu")
        assert is_paged(ct[0]) == (layout == "paged")
        assert jpaged(cj[0]) == is_paged(ct[0])   # cj[0]: a stacked group
    assert not is_paged(None) and not jpaged(None)


def test_examples_run_on_cpu(tmp_path, capsys):
    from repro_torch.launch import lexi_optimize, quickstart
    assert quickstart.main(["--device", "cpu", "--n-iter", "2"]) == 0
    out = capsys.readouterr().out
    assert "LExI plan @ budget" in out and "(finite)" in out
    assert lexi_optimize.main(["--device", "cpu", "--arch",
                               "qwen3-moe-235b-a22b", "--n-iter", "2",
                               "--generations", "40",
                               "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "budget sweep" in out and "gap=" in out
    assert {p.name for p in tmp_path.iterdir()} == {
        "qwen3-moe-235b-a22b.plan.json",
        "qwen3-moe-235b-a22b.sensitivity.json"}
    with pytest.raises(SystemExit, match="inapplicable"):
        lexi_optimize.main(["--device", "cpu", "--arch",
                            "llama4-scout-17b-a16e"])


def test_repaired_parameters_take_the_references_calls():
    """C10's repairs: ``gqa_attention(rope=False)`` leaves q and k
    unrotated as the reference's does (f32, 1e-5); ``unpack_int4`` takes
    ``axis=``; ``encdec_loss`` takes ``aux_coef=`` and drops it."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models.attention import gqa_attention as jgqa
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.models.attention import gqa_attention, init_attention
    from repro_torch.models.encdec import encdec_loss
    from repro_torch.models.moe import unpack_int4
    cfg_t = get_config("olmoe-1b-7b").reduced().with_(dtype="float32")
    cfg_j = jget("olmoe-1b-7b").reduced().with_(dtype="float32")
    attn = init_attention(torch.Generator().manual_seed(0), cfg_t, "cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, cfg_t.d_model)).astype(np.float32)
    pos = np.tile(np.arange(8, dtype=np.int32), (2, 1))
    for rope in (False, True):
        got, _ = gqa_attention(attn, cfg_t, torch.from_numpy(x),
                               torch.from_numpy(pos), rope=rope)
        want, _ = jgqa(jax.tree.map(lambda v: jnp.asarray(v.numpy()), attn),
                       cfg_j, jnp.asarray(x), jnp.asarray(pos), rope=rope)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    packed = torch.tensor([[0x7F, -0x80], [0x18, 0x0F]], dtype=torch.int8)
    assert torch.equal(unpack_int4(packed, axis=1), unpack_int4(packed, 1))
    wcfg = get_config("whisper-base").reduced().with_(num_layers=1)
    params = tm.init_params(wcfg, 0, device="cpu")
    batch = tm.make_train_batch(wcfg, torch.Generator().manual_seed(1), 2,
                                8, device="cpu")
    assert torch.equal(encdec_loss(params, wcfg, batch, aux_coef=0.5)[0],
                       encdec_loss(params, wcfg, batch)[0])


#: one config a family kind: GQA, MLA, mamba (and a hybrid with shared
#: attention), encoder-decoder
CACHE_KINDS = ("olmoe-1b-7b", "deepseek-v2-lite", "mamba2-780m",
               "zamba2-1.2b", "whisper-base")


def _per_layer(tree, counts):
    """{leaf path: (shape, dtype)} a layer: a stacked group's leading dim
    cut off for each of its ``counts`` layers."""
    import jax
    out = []
    for group, n in zip(tree, counts):
        leaves = {}
        for path, x in jax.tree_util.tree_flatten_with_path(group)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            leaves[key] = (tuple(x.shape)[1 if n > 1 else 0:], str(x.dtype))
        out += [leaves] * n
    return out


@pytest.fixture(scope="module")
def reference_caches():
    """The reference's bare ``init_caches(cfg, 2, 32)`` of each kind, per
    layer."""
    from repro import models as jm
    from repro.configs import get_config as jget
    from repro.models.blocks import group_pattern
    out = {}
    for name in CACHE_KINDS:
        cfg = jget(name).reduced()
        counts = ([1] * cfg.num_layers if cfg.is_encoder_decoder else
                  [g.count for g in group_pattern(cfg.pattern())])
        out[name] = _per_layer(jm.init_caches(cfg, 2, 32), counts)
    return out


@pytest.mark.parametrize("name", CACHE_KINDS)
def test_init_caches_default_is_the_references_contiguous_rows(
        reference_caches, name):
    """C8: a bare ``init_caches(cfg, B, S)`` builds the reference's default
    layout, ``B`` contiguous rows of ``S`` positions (a mamba layer's
    state rows, whisper's self and cross caches): each layer's leaves with
    the reference's shapes and dtypes, the port keeping one cache a layer
    where the reference stacks a run."""
    from repro_torch import models as tm
    from repro_torch.configs import get_config
    from repro_torch.tree import flatten_with_paths
    got = [{p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in flatten_with_paths(layer)}
           for layer in tm.init_caches(get_config(name).reduced(), 2, 32,
                                       device="cpu")]
    assert got == reference_caches[name]


# --------------------------------------------------------------------------- #
# Signature parity
# --------------------------------------------------------------------------- #

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
#: a reference module whose counterpart has another name
RENAMED = {"analysis/hlo.py": "analysis/collectives.py"}
#: outside the walk: the kernels' jnp fallbacks and references, which the
#: wrappers and their ``*_plain`` versions replace (and the ``*_pallas``
#: names, skipped in every module)
OUTSIDE = ("kernels/ops.py", "kernels/ref.py")
PAIRS = sorted(r for r in (str(f.relative_to(SRC / "repro"))
                           for f in (SRC / "repro").rglob("*.py"))
               if r not in OUTSIDE)

_KEY = ("a PRNG key: the port draws from a torch.Generator (``gen``) or an "
        "int ``seed``")
_DEVICE = ("the device an init function makes its tensors on, handed "
           "down by the entry points (``models.init_params`` / "
           "``init_caches``, ``Engine``), which default it to the card")
_KNOB = ("an XLA compiler knob; the port runs eager layers on the rank's "
         "blocks, so there is nothing to unroll, constrain or compose "
         "(ROADMAP A, \"Not needed\": ``composed_costs``)")
_COMPILED = ("reads a compiled XLA executable; the port's dry run counts "
             "the step as it runs (``analysis.counters``)")
_STACKED = ("the port keeps a list of layers, not the reference's stacked "
            "groups (ROADMAP A, \"Not needed\")")
_AXES = ("a shard_map body's axis names for the aux mean; the port's body "
         "takes a bound ``mesh`` and returns the rank's aux, meaned over "
         "``model`` by ``moe_ep_a2a``: a rank's loss is its data block's "
         "(ROADMAP C, caveats)")

#: divergences the port keeps, each with its reason: ``module::name`` (a
#: name the port lacks), ``module::name(param)`` (a reference parameter
#: it lacks) or ``module::name(+param)`` (a parameter it adds with no
#: default); ``*::`` holds in every module
EXEMPT = {
    "*::(key)": _KEY,
    "*::(+gen)": _KEY,
    "*::(+device)": _DEVICE,
    "analysis/hlo.py::collective_stats": (
        "parses XLA's HLO text; the port notes each collective as it runs "
        "(``analysis.collectives.record``)"),
    "analysis/roofline.py::costs_from_compiled": _COMPILED,
    "analysis/roofline.py::analyze": _COMPILED,
    "analysis/roofline.py::device_memory(compiled)": _COMPILED,
    "analysis/roofline.py::device_memory(+counts)": (
        "the dry run's ``Counts`` in place of the executable: their peak"),
    "kernels/moe_decode.py::moe_decode_routed_jnp": (
        "a jnp fallback: the wrapper runs its ``*_plain`` version on a CPU "
        "tensor"),
    "kernels/moe_decode.py::moe_decode_routed_quant_jnp": (
        "a jnp fallback: the wrapper runs its ``*_plain`` version on a CPU "
        "tensor"),
    "launch/dryrun.py::cell_opts(scan_unroll)": _KNOB,
    "launch/dryrun.py::cell_opts(act_constraint)": _KNOB,
    "launch/dryrun.py::run_cell(compose)": _KNOB,
    "launch/dryrun.py::composed_costs": _KNOB,
    "models/opts.py::ModelOpts(scan_unroll)": _KNOB,
    "models/opts.py::ModelOpts(act_constraint)": _KNOB,
    "models/attention.py::gqa_attention(seq_shard_mesh)": (
        "the port's per-rank program takes the mesh as ``mesh=`` and "
        "context-parallel decode as ``seq_shard=True``, in prefill too: "
        "the rank writes its own sequence block of the cache, which GSPMD "
        "shards for the reference"),
    "models/blocks.py::apply_stack(params)": _STACKED,
    "models/blocks.py::apply_stack(+layers)": _STACKED,
    "models/blocks.py::ungroup_stack": _STACKED,
    "models/blocks.py::regroup_stack": _STACKED,
    "models/common.py::zeros_init": (
        "a keyed initialiser; the port builds with ``torch.zeros``"),
    "models/common.py::ones_init": (
        "a keyed initialiser; the port builds with ``torch.ones``"),
    "models/common.py::split_keys": _KEY,
    "models/moe/ep.py::moe_ep_a2a_local(all_axes)": _AXES,
    "models/moe/ep.py::moe_ep_a2a_local(+mesh)": _AXES,
    "models/moe/ep.py::moe_ep_psum_local(token_axes)": _AXES,
    "models/moe/ep.py::moe_ep_psum_local(+mesh)": _AXES,
    "sharding/rules.py::np_prod": (
        "an integer product of a shape; the port uses ``math.prod``"),
}

_DTYPE = re.compile(r"\bjnp\.(float32|bfloat16|float16|int8|int32)\b")


def _default(node):
    return None if node is None else _DTYPE.sub(r"torch.\1",
                                                ast.unparse(node))


def _params(args):
    """[(name, default source or None, positional)] of a ``def``."""
    pos = args.posonlyargs + args.args
    dflt = [None] * (len(pos) - len(args.defaults)) + list(args.defaults)
    out = [(p.arg, _default(d), True) for p, d in zip(pos, dflt)]
    out += [(p.arg, _default(d), False)
            for p, d in zip(args.kwonlyargs, args.kw_defaults)]
    return [p for p in out if p[0] not in ("self", "cls")]


def _signatures(path: pathlib.Path):
    """Public name -> its parameters: a function's, a class's ``__init__``'s
    or its fields (a dataclass, a NamedTuple), else none."""
    sigs = {}
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                or node.name.startswith("_"):
            continue
        if isinstance(node, ast.FunctionDef):
            sigs[node.name] = _params(node.args)
            continue
        init = [n for n in node.body
                if isinstance(n, ast.FunctionDef) and n.name == "__init__"]
        fields = any("dataclass" in ast.unparse(d)
                     for d in node.decorator_list) or any(
            ast.unparse(b) == "NamedTuple" for b in node.bases)
        sigs[node.name] = (
            _params(init[0].args) if init else
            [(n.target.id, _default(n.value), True) for n in node.body
             if isinstance(n, ast.AnnAssign)
             and isinstance(n.target, ast.Name)
             and "ClassVar" not in ast.unparse(n.annotation)]
            if fields else [])
    return sigs


def _divergences(ref_mod: str, port_mod: str):
    ref = _signatures(SRC / "repro" / ref_mod)
    port = _signatures(SRC / "repro_torch" / port_mod)
    out = []
    for name, rp in ref.items():
        if name.endswith("_pallas"):
            continue
        if name not in port:
            out.append((name, None))
            continue
        pp = {n: (d, pos) for n, d, pos in port[name]}
        for n, d, pos in rp:
            if n not in pp:
                out.append((name, n))
            elif d is not None and d != pp[n][0]:
                out.append((name, f"{n}={d} is {pp[n][0]}"))
            elif pos and not pp[n][1]:
                out.append((name, f"{n} is keyword-only"))
        req = [n for n, d, pos in rp if pos and d is None and n in pp]
        if [n for n, _, _ in port[name] if n in req] != req:
            out.append((name, f"order of {req}"))
        out += [(name, f"+{n}") for n, d, _ in port[name]
                if d is None and n not in {r for r, _, _ in rp}]
    return out


def _reason(mod: str, name: str, param):
    tail = "" if param is None else f"({param})"
    return EXEMPT.get(f"{mod}::{name}{tail}",
                      None if param is None else EXEMPT.get(f"*::{tail}"))


@pytest.fixture(scope="module")
def walked():
    """Every pair's divergences (the reference's tree, parsed once)."""
    return {m: _divergences(m, RENAMED.get(m, m)) for m in PAIRS}


@pytest.mark.parametrize("mod", PAIRS)
def test_signatures_match_reference(walked, mod):
    """A call written for the reference binds in the port: the reference's
    names, parameters and defaults, or a reason in ``EXEMPT``."""
    assert (SRC / "repro_torch" / RENAMED.get(mod, mod)).exists(), mod
    open_ = [f"{n}({p})" if p else n for n, p in walked[mod]
             if _reason(mod, n, p) is None]
    assert not open_, f"{mod}: {open_}"


def test_every_exemption_is_used_and_has_a_reason(walked):
    """No stale entry: each named exemption matches a divergence the walk
    finds, and each reason is one line of text."""
    seen = {f"{m}::{n}" + ("" if p is None else f"({p})")
            for m, d in walked.items() for n, p in d}
    stale = [k for k in EXEMPT if not k.startswith("*::") and k not in seen]
    assert not stale, stale
    assert all(r.strip() and "\n" not in r for r in EXEMPT.values())
