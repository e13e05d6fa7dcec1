"""The reference's public names that the port adds late (ROADMAP A15),
each against its counterpart: ``core.lexi_config``, ``serving.sample``,
``models.moe.register_impl`` / ``available_impls``,
``models.common.count_params``, ``models.make_train_batch`` (a
``torch.Generator`` in place of the key), ``models.attention.is_paged``;
and the examples' launchers ``launch/quickstart.py`` and
``launch/lexi_optimize.py`` on ``--device cpu``."""

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
