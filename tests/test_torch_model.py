"""Parity of the PyTorch port's model and LExI core with the JAX reference.

* ``chunk_prefill_fn`` and ``decode_fn`` logits, base and under a LExI plan,
  on the reference's own weights (``convert.py``) and the same paged pool
  layout, with the kernel options on (their plain versions run on CPU).
* The sensitivity table from the port's per-draw function fed the
  reference's own X draws, against ``profile_sensitivity``.
* ``optimize`` returns the same plan as the reference for the same table.
* ``loss_fn`` with ``use_flash`` (the ``flash_attention`` kernel's plain
  version on the CPU) against the reference's ``loss_fn`` with
  ``use_flash`` (its Pallas kernel in interpret mode), for the base model,
  a LExI plan (``apply_plan_params``), and the ``inter_prune`` /
  ``intra_prune`` baselines at 0.25 -- whose pruned experts must be the
  reference's own (the same kept indices), compared on the reference's
  pruned params converted.

Tolerance: f32 logits and losses through 4 layers, ``rtol=atol=1e-4``
(products summed in another order at every layer; the observed gap is
~5e-6).  Sensitivity values are norms of output differences:
``rtol=1e-4``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    import jax
    from repro import models as jm
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    from repro_torch.convert import convert_params
    cfg_j = jget("olmoe-1b-7b").reduced().with_(moe_impl="gmm")
    cfg_t = tget("olmoe-1b-7b").reduced().with_(moe_impl="gmm")
    pj = jax.jit(lambda k: jm.init_params(k, cfg_j))(jax.random.PRNGKey(0))
    pt = convert_params(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.mark.parametrize("plan", [None, (2, 1, 1, 2)])
def test_chunk_prefill_and_decode_logits_match_reference(setup, plan):
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro.models.blocks import regroup_stack
    from repro_torch import models as tm
    cfg_j, cfg_t, pj, pt = setup
    if plan is not None:
        cfg_j2 = cfg_j.with_lexi_plan(plan)
        pj = dict(pj, stack=regroup_stack(pj["stack"], cfg_j.pattern(),
                                          cfg_j2.pattern()))
        cfg_j, cfg_t = cfg_j2, cfg_t.with_lexi_plan(plan)
    rng = np.random.default_rng(0)
    b, c, p, n = 2, 8, 16, 9
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    cj = jm.init_caches(cfg_j, b, 64, layout="paged", page_size=p,
                        num_pages=n)
    ct = tm.init_caches(cfg_t, page_size=p, num_pages=n, device="cpu")
    kern = tm.ModelOpts(use_moe_kernel=True, use_paged_kernel=True,
                        use_moe_decode_kernel=True)
    jopts = jm.ModelOpts(use_paged_kernel=True, use_moe_decode_kernel=True)
    # one compiled graph per reference step (eager op-by-op is slower)
    jchunk = jax.jit(lambda p_, t, po, c_, li, bt_: jm.chunk_prefill_fn(
        p_, cfg_j, t, po, c_, last_index=li, block_tables=bt_))
    jdecode = jax.jit(lambda p_, t, po, c_, bt_: jm.decode_fn(
        p_, cfg_j, t, po, c_, block_tables=bt_, opts=jopts, kernel_blocks=2))
    for step in range(2):
        tok = rng.integers(0, cfg_j.vocab_size, (b, c)).astype(np.int32)
        pos = (np.arange(c)[None] + step * c).repeat(b, 0).astype(np.int32)
        if step == 1:
            pos[1, 5:] = -1                 # row 1's prompt ends mid-chunk
        last = np.array([c - 1, 4], np.int32)
        lj, cj = jchunk(pj, jnp.asarray(tok), jnp.asarray(pos), cj,
                        jnp.asarray(last), jnp.asarray(bt))
        lt, ct = tm.chunk_prefill_fn(pt, cfg_t, torch.from_numpy(tok),
                                     torch.from_numpy(pos), ct,
                                     last_index=torch.from_numpy(last),
                                     block_tables=torch.from_numpy(bt),
                                     opts=kern)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    tok = np.asarray(lj).argmax(-1).astype(np.int32)
    pos = np.array([16, 13], np.int32)
    lj, _ = jdecode(pj, jnp.asarray(tok), jnp.asarray(pos), cj,
                    jnp.asarray(bt))
    lt, _ = tm.decode_fn(pt, cfg_t, torch.from_numpy(tok),
                         torch.from_numpy(pos), ct,
                         block_tables=torch.from_numpy(bt), opts=kern,
                         kernel_blocks=2)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_sensitivity_table_and_plans_match_reference(setup):
    import jax
    from repro.core import optimize as joptimize, profile_sensitivity
    from repro_torch.core import SensitivityTable, iter_moe_layer_params, \
        layer_deltas, optimize as toptimize
    cfg_j, cfg_t, pj, pt = setup
    n_iter, batch, seq, seed = 2, 2, 8, 5
    want = profile_sensitivity(pj, cfg_j, n_iter=n_iter, batch=batch,
                               seq=seq, key=jax.random.PRNGKey(seed))
    key = jax.random.PRNGKey(seed)
    rows = []
    for layer_idx, moe_p in iter_moe_layer_params(pt, cfg_t):
        acc = np.zeros(cfg_t.moe_top_k)
        for it in range(n_iter):
            # the reference's own draw for (layer, iteration)
            x = jax.random.normal(
                jax.random.fold_in(key, layer_idx * 131071 + it),
                (batch * seq, cfg_j.d_model))
            acc += layer_deltas(moe_p, cfg_t, torch.from_numpy(np.array(x)),
                                range(1, cfg_t.moe_top_k + 1)).double().numpy()
        rows.append(acc / n_iter)
    np.testing.assert_allclose(np.stack(rows), want.values, rtol=1e-4)
    table = SensitivityTable(
        arch=want.arch, k_base=want.k_base,
        moe_layer_indices=tuple(want.moe_layer_indices),
        target_topks=tuple(want.target_topks), n_iter=n_iter,
        values=np.stack(rows))
    for method, budget in (("dp", 5), ("dp", 6), ("evolutionary", 6)):
        kw = dict(method=method, seed=1)
        pj_plan = joptimize(pj, cfg_j, budget, table=want, **kw)
        pt_plan = toptimize(pt, cfg_t, budget, table=table, device="cpu",
                            **kw)
        assert tuple(pt_plan.plan) == tuple(pj_plan.plan), (method, budget)


def test_profile_sensitivity_runs_on_cpu_generator(setup):
    from repro_torch.core import profile_sensitivity
    _, cfg_t, _, pt = setup
    t = profile_sensitivity(pt, cfg_t, n_iter=1, batch=1, seq=8, seed=0,
                            device="cpu")
    assert t.values.shape == (cfg_t.num_moe_layers, cfg_t.moe_top_k)
    # k == k_base reproduces the baseline exactly
    assert np.all(t.values[:, -1] == 0.0) and np.all(t.values[:, 0] > 0)


@pytest.mark.parametrize("variant", ["base", "lexi", "inter_prune",
                                     "intra_prune"])
def test_loss_fn_with_flash_matches_reference(setup, variant):
    import jax
    import jax.numpy as jnp
    from repro import core as jcore, models as jm
    from repro_torch import core as tcore, models as tm
    from repro_torch.convert import convert_params
    cfg_j, cfg_t, pj, pt = setup
    if variant == "lexi":
        plan_j = jcore.LexiPlan(arch=cfg_j.name, budget=6, plan=(2, 1, 1, 2),
                                fitness=0.0, method="dp", k_base=2)
        plan_t = tcore.LexiPlan(arch=cfg_t.name, budget=6, plan=(2, 1, 1, 2),
                                fitness=0.0, method="dp", k_base=2)
        cfg_j, pj = jcore.apply_plan_params(pj, cfg_j, plan_j)
        cfg_t, pt = tcore.apply_plan_params(pt, cfg_t, plan_t)
    elif variant != "base":
        pj, cfg_j = getattr(jcore, variant)(pj, cfg_j, 0.25)
        pt, cfg_t = getattr(tcore, variant)(pt, cfg_t, 0.25)
        assert (cfg_t.num_experts, cfg_t.moe_d_ff) == (cfg_j.num_experts,
                                                       cfg_j.moe_d_ff)
        want = convert_params(jax.tree.map(np.asarray, pj), cfg_t,
                              device="cpu")
        for lt, lw in zip(pt["layers"], want["layers"]):
            for name in ("router", "w1", "w2"):      # same kept indices
                assert torch.equal(lt["moe"][name], lw["moe"][name]), name
    rng = np.random.default_rng(4)
    b, s = 2, 24
    batch = {"tokens": rng.integers(0, cfg_j.vocab_size, (b, s)),
             "targets": rng.integers(0, cfg_j.vocab_size, (b, s)),
             "mask": (rng.random((b, s)) > 0.2).astype(np.int32)}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    jloss = jax.jit(lambda p_, b_: jm.loss_fn(
        p_, cfg_j, b_, opts=jm.ModelOpts(use_flash=True)))
    lj, mj = jloss(pj, {k: jnp.asarray(v) for k, v in batch.items()})
    lt, mt = tm.loss_fn(pt, cfg_t, {k: torch.from_numpy(v)
                                    for k, v in batch.items()},
                        opts=tm.ModelOpts(use_flash=True,
                                          use_moe_kernel=True))
    np.testing.assert_allclose(lt.item(), float(lj), **TOL)
    np.testing.assert_allclose(mt["xent"].item(), float(mj["xent"]), **TOL)
    np.testing.assert_allclose(mt["aux"].item(), float(mj["aux"]), **TOL)


def test_router_mc_pruning_keeps_the_most_routed_experts(setup):
    from repro_torch.core import inter_prune
    from repro_torch.core.pruning import _expert_scores_router_mc
    _, cfg_t, _, pt = setup
    p2, cfg2 = inter_prune(pt, cfg_t, 0.25, method="router_mc")
    assert cfg2.num_experts == 6
    for lp, lp2 in zip(pt["layers"], p2["layers"]):
        mass = _expert_scores_router_mc(lp["moe"], cfg_t)
        # top-k probabilities of 4096 draws: each draw adds at most 1
        assert 0 < mass.sum().item() <= 4096 * (1 + 1e-5)
        keep = torch.topk(mass, 6).indices.sort().values
        assert torch.equal(lp2["moe"]["w1"], lp["moe"]["w1"][keep])
        assert lp2["attn"] is lp["attn"]        # shared, not copied


def test_forward_launcher_runs_on_cpu(capsys):
    import json
    from repro_torch.launch.forward import main
    assert main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                 "--batch", "1", "--seq", "16", "--reps", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # the config's own dense impl, and the baseline and plan on gmm too
    assert set(rec["models"]) == {"baseline", "lexi", "inter_prune_0.25",
                                  "intra_prune_0.25", "baseline~gmm",
                                  "lexi~gmm", "dyn_skip_tau0.3"}
    assert rec["models"]["inter_prune_0.25"]["experts"] == 6
    assert rec["models"]["intra_prune_0.25"]["moe_d_ff"] == 48
    assert all(np.isfinite(m["xent"]) for m in rec["models"].values())
