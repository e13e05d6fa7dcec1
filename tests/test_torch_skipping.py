"""The NAEE dynamic-skipping baseline (``core/skipping.py``) in the port
against the JAX reference.

* ``with_dynamic_skipping`` refuses top-k < 2, as the reference does, and
  sets ``dynamic_skip_tau`` otherwise.
* ``expected_skip_rate`` is within 0.03 of the reference's at 4096
  samples.  The two draw different normal samples (a torch generator and a
  JAX key, each seeded by ``seed``), so the bound is a Monte-Carlo one: at
  tau 0.6 one estimate's standard deviation is about 0.009 over seeds, and
  two independent ones differ by 0.0125 in the root mean square, so the
  test holds the mean of four seeds on each side (0.006).  On the
  reference's own draw, the port's share (``skip_share``) is the
  reference's exactly.
* ``loss_fn`` with ``dynamic_skip_tau`` 0.3 equals the reference's within
  the f32 tolerance of the other port tests, on the dense and gmm impls,
  and differs from the loss without skipping.
* ``launch/forward.py --reduced --device cpu`` prints the
  ``dyn_skip_tau0.3`` row with its ``expected_skip_rate``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402


TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    import jax
    from repro import models as jm
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    from repro_torch.convert import convert_params
    cfg_j = jget("olmoe-1b-7b").reduced().with_(dtype="float32")
    cfg_t = tget("olmoe-1b-7b").reduced().with_(dtype="float32")
    pj = jax.jit(lambda k: jm.init_params(k, cfg_j))(jax.random.PRNGKey(0))
    pt = convert_params(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


def test_with_dynamic_skipping_refuses_top1_as_reference():
    from repro.configs import get_config as jget
    from repro.core import with_dynamic_skipping as jskip
    from repro_torch.configs import get_config as tget
    from repro_torch.core import with_dynamic_skipping
    for get, skip in ((jget, jskip), (tget, with_dynamic_skipping)):
        cfg = get("olmoe-1b-7b").reduced()
        with pytest.raises(ValueError, match="top-k >= 2"):
            skip(cfg.with_(moe_top_k=1), 0.5)
        assert skip(cfg, 0.5).dynamic_skip_tau == 0.5


@pytest.mark.parametrize("tau", [0.1, 0.3, 0.6])
def test_expected_skip_rate_matches_reference(setup, tau):
    import jax
    from repro.core import expected_skip_rate as jrate, \
        iter_moe_layer_params as jlayers
    from repro_torch.core import expected_skip_rate, iter_moe_layer_params
    from repro_torch.core.skipping import skip_share
    cfg_j, cfg_t, pj, pt = setup
    _, mj = next(iter(jlayers(pj, cfg_j)))
    _, mt = next(iter(iter_moe_layer_params(pt, cfg_t)))
    seeds = range(4)
    want = [jrate(mj, cfg_j, tau, seed=s) for s in seeds]
    got = [expected_skip_rate(mt, cfg_t, tau, seed=s) for s in seeds]
    assert all(0.0 <= g <= 1.0 for g in got)
    assert abs(np.mean(got) - np.mean(want)) <= 0.03, (got, want)
    # the draw is seeded: the same seed, the same share
    assert expected_skip_rate(mt, cfg_t, tau, seed=0) == got[0]
    # on the reference's own draw, its share
    x = np.array(jax.random.normal(jax.random.PRNGKey(0),
                                   (4096, cfg_j.d_model)))
    assert skip_share(mt, cfg_t, tau, torch.from_numpy(x)) == want[0]


@pytest.mark.parametrize("impl", ["dense", "gmm"])
def test_loss_with_dynamic_skipping_matches_reference(setup, impl):
    import jax
    import jax.numpy as jnp
    from repro import core as jcore, models as jm
    from repro_torch import core as tcore, models as tm
    cfg_j, cfg_t, pj, pt = setup
    cfg_j = jcore.with_dynamic_skipping(cfg_j.with_(moe_impl=impl), 0.3)
    cfg_t = tcore.with_dynamic_skipping(cfg_t.with_(moe_impl=impl), 0.3)
    rng = np.random.default_rng(4)
    b, s = 2, 24
    batch = {n: rng.integers(0, cfg_j.vocab_size, (b, s)).astype(np.int32)
             for n in ("tokens", "targets")}
    batch["mask"] = np.ones((b, s), np.int32)
    lj, mj = jax.jit(lambda p_, b_: jm.loss_fn(p_, cfg_j, b_))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    opts = tm.ModelOpts(use_flash=True, use_moe_kernel=True)
    lt, mt = tm.loss_fn(pt, cfg_t, tb, opts=opts)
    np.testing.assert_allclose(mt["xent"].item(), float(mj["xent"]), **TOL)
    np.testing.assert_allclose(lt.item(), float(lj), **TOL)
    _, m0 = tm.loss_fn(pt, cfg_t.with_(dynamic_skip_tau=0.0), tb, opts=opts)
    assert m0["xent"].item() != mt["xent"].item()


def test_forward_launcher_prints_dyn_skip_row(capsys):
    import json
    from repro_torch.launch.forward import main
    assert main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                 "--batch", "1", "--seq", "16", "--reps", "1",
                 "--skip-tau", "0.3"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    row = rec["models"]["dyn_skip_tau0.3"]
    assert row["moe_impl"] == "dense" and row["tau"] == 0.3
    assert 0.0 < row["expected_skip_rate"] < 1.0
    assert np.isfinite(row["xent"]) and row["ms_median"] > 0
