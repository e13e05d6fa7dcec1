"""The stateful stacks against the JAX reference on the CPU: mamba2-780m
(every layer a Mamba2 SSD block, tied embeddings) and zamba2-1.2b (Mamba2
blocks with one shared attention block re-applied every ``attn_period``
layers).

Both run at ``.reduced()`` widths (d_model 128, SSM state 16, heads of 16,
SSD chunk 16, f32): mamba2 2 layers deep, zamba2 4 at ``attn_period`` 2,
so its shared block occurs twice.  The port's own init is given to the
reference as its stacked tree (``_torch_ref.reference_params``).

* ``loss_fn`` and every gradient within 1e-4 of the reference's (the
  shared block's gradient is the sum over its occurrences on both sides).
* The reference's prefill-then-decode consistency, port against reference.
* ``mamba_forward`` in train, prefill and decode mode at three chunks, at
  S below W-1 (the conv tail), and the reference's ValueError at a ragged
  S.
* Greedy engine tokens (contiguous, whole prompts) equal the JAX engine's
  at lengths that are multiples of ``prefill_pad`` (the JAX engine runs
  its left pads through the SSM), and the reference's ``prefill_fn`` plus
  ``decode_fn`` at other lengths; a request in a reused slot equals the
  same request served alone.
* The engine refuses what the reference engine refuses (paged, chunked,
  prefix cache, router lookahead) and rejects a ragged prompt.
* ``convert_params`` / ``convert_train_state`` round-trip zamba2 with its
  shared params once, and compression scales its groups as the reference.

Every JAX oracle is built once per config (module-scoped fixtures).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_ref import reference_params  # noqa: E402
from _torch_threads import one_thread  # noqa: F401,E402

TOL = dict(rtol=1e-4, atol=1e-4)
#: name -> the depth the tests run at
CONFIGS = {"mamba2-780m": 2, "zamba2-1.2b": 4}


@pytest.fixture(scope="module", params=list(CONFIGS))
def stack(request):
    """(cfg_j, cfg_t, reference params, the port's params)."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    from repro_torch.models import init_params
    n = CONFIGS[request.param]
    cfg_j = jget(request.param).reduced().with_(num_layers=n)
    cfg_t = tget(request.param).reduced().with_(num_layers=n)
    pt = init_params(cfg_t, 0, device="cpu")
    return cfg_j, cfg_t, reference_params(pt, cfg_t), pt


def _batch(cfg, b=2, s=32, seed=4):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "mask": (rng.random((b, s)) > 0.2).astype(np.int32)}


def _port_grads(pt, cfg, batch):
    """(loss, metrics, grads) of the port's ``loss_fn``, grads in the
    params' tree."""
    from repro_torch import models as tm
    from repro_torch.tree import map_tree
    p = map_tree(lambda t: t.detach().clone().requires_grad_(), pt)
    loss, m = tm.loss_fn(p, cfg, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    loss.backward()
    return loss, m, map_tree(lambda t: t.grad, p)


def _assert_trees_close(got, want, **tol):
    from repro_torch.tree import flatten_with_paths
    got, want = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   err_msg=k, **tol)


def test_loss_and_grads_match_reference(stack):
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    cfg_j, cfg_t, pj, pt = stack
    if cfg_t.attn_period:
        kinds = [s.kind for s in cfg_t.pattern()]
        assert kinds.count("shared_attn") == 2 and "shared_attn" in pt
        assert all(lp == {} for lp, k in zip(pt["layers"], kinds)
                   if k == "shared_attn")
    batch = _batch(cfg_t)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p, b_: jm.loss_fn(p, cfg_j, b_), has_aux=True))(
            pj, {k: jnp.asarray(v) for k, v in batch.items()})
    lt, mt, gt = _port_grads(pt, cfg_t, batch)
    np.testing.assert_allclose(lt.item(), float(lj), **TOL)
    np.testing.assert_allclose(mt["xent"].item(), float(mj["xent"]), **TOL)
    _assert_trees_close(reference_params(gt, cfg_t),
                        jax.tree.map(np.asarray, gj), **TOL)


def test_prefill_decode_consistency_matches_reference(stack):
    """The reference's ``test_prefill_decode_consistency`` held port
    against reference: prefill of S-1 tokens, one decode step, and the
    train-mode logits at the last two positions."""
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro.models import transformer as jtf
    from repro_torch import models as tm
    from repro_torch.models import transformer as ttf
    cfg_j, cfg_t, pj, pt = stack
    b, s = 2, 16
    tokens = _batch(cfg_t, b, s)["tokens"]
    cj = jm.init_caches(cfg_j, b, 64)
    lpj, cj = jax.jit(lambda p, t, c: jm.prefill_fn(p, cfg_j, {"tokens": t},
                                                    c))(
        pj, jnp.asarray(tokens[:, :-1]), cj)
    ldj, _ = jax.jit(lambda p, t, po, c: jm.decode_fn(p, cfg_j, t, po, c))(
        pj, jnp.asarray(tokens[:, -1]), jnp.full((b,), s - 1, jnp.int32), cj)
    ct = tm.init_caches(cfg_t, b, 64, layout="contiguous", device="cpu")
    lpt, ct = tm.prefill_fn(pt, cfg_t,
                            {"tokens": torch.from_numpy(tokens[:, :-1])}, ct)
    ldt, _ = tm.decode_fn(pt, cfg_t, torch.from_numpy(tokens[:, -1]),
                          torch.full((b,), s - 1, dtype=torch.int32), ct)
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    with torch.no_grad():
        hid, _, _ = ttf.forward(pt, cfg_t, torch.from_numpy(tokens), pos)
        full_t = ttf.lm_logits(pt, cfg_t, hid)
    full_j = np.asarray(jax.jit(lambda p, t, po: jtf.lm_logits(
        p, cfg_j, jtf.forward(p, cfg_j, t, po, mode="train")[0]))(
            pj, jnp.asarray(tokens), jnp.asarray(pos.numpy())))
    np.testing.assert_allclose(lpt.numpy(), np.asarray(lpj), **TOL)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), **TOL)
    np.testing.assert_allclose(full_t.numpy(), full_j, **TOL)
    # and the reference test's own claim, on the port: prefill and decode
    # equal the train-mode forward at their positions
    np.testing.assert_allclose(lpt.numpy(), full_t[:, -2].numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ldt.numpy(), full_t[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.fixture(scope="module")
def mixer():
    """One Mamba2 mixer of mamba2's reduced config: (cfg_j, cfg_t, the
    reference's params, the port's)."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    from repro_torch.models.ssm import init_mamba
    cfg_j, cfg_t = jget("mamba2-780m").reduced(), tget("mamba2-780m").reduced()
    gen = torch.Generator().manual_seed(2)
    pt = init_mamba(gen, cfg_t, "cpu")
    return cfg_j, cfg_t, {k: v.numpy() for k, v in pt.items()}, pt


@pytest.mark.parametrize("s", [48, 2], ids=["three_chunks", "below_conv"])
def test_mamba_forward_modes_match_reference(mixer, s):
    """Train and prefill over S tokens (S 48: three SSD chunks of 16; S 2:
    under the conv's W-1 = 3, so the conv tail is left-padded), then three
    decode steps from the prefilled cache: outputs and caches."""
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm
    cfg_j, cfg_t, pj, pt = mixer
    assert cfg_t.ssm_chunk == 16 and cfg_t.ssm_conv_width == 4
    rng = np.random.default_rng(s)
    b, d = 2, cfg_t.d_model
    x = rng.standard_normal((b, s + 3, d)).astype(np.float32)
    oj, _ = jssm.mamba_forward(pj, cfg_j, jnp.asarray(x[:, :s]), mode="train")
    with torch.no_grad():
        ot, none = tssm.mamba_forward(pt, cfg_t, torch.from_numpy(x[:, :s]),
                                      mode="train")
    assert none is None
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)

    cj = jssm.init_mamba_cache(cfg_j, b)
    ct = tssm.init_mamba_cache(cfg_t, b, "cpu")
    oj, cj = jssm.mamba_forward(pj, cfg_j, jnp.asarray(x[:, :s]),
                                mode="prefill", cache=cj)
    with torch.no_grad():
        ot, ct2 = tssm.mamba_forward(pt, cfg_t, torch.from_numpy(x[:, :s]),
                                     mode="prefill", cache=ct)
    assert ct2 is ct                                   # written in place
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    for i in range(s, s + 3):
        oj, cj = jssm.mamba_forward(pj, cfg_j, jnp.asarray(x[:, i:i + 1]),
                                    mode="decode", cache=cj)
        addr = {k: v.data_ptr() for k, v in ct.items()}
        with torch.no_grad():
            ot, ct = tssm.mamba_forward(pt, cfg_t,
                                        torch.from_numpy(x[:, i:i + 1]),
                                        mode="decode", cache=ct)
        assert {k: v.data_ptr() for k, v in ct.items()} == addr
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
        for k in ("conv", "state"):
            np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]),
                                       err_msg=k, **TOL)


def test_mamba_forward_refuses_a_ragged_sequence(mixer):
    import jax.numpy as jnp
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm
    cfg_j, cfg_t, pj, pt = mixer
    x = np.zeros((1, 20, cfg_t.d_model), np.float32)
    msg = "seq 20 not divisible by ssm chunk 16"
    with pytest.raises(ValueError, match=msg):
        jssm.mamba_forward(pj, cfg_j, jnp.asarray(x))
    with pytest.raises(ValueError, match=msg):
        tssm.mamba_forward(pt, cfg_t, torch.from_numpy(x))


def _requests(mod, lens, max_new=5, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=rng.integers(0, 256, n).astype(np.int32),
                        max_new_tokens=max_new) for i, n in enumerate(lens)]


def _port_engine(cfg, pt, **kw):
    from repro_torch.models import ModelOpts
    from repro_torch.serving import Engine
    kw = dict(dict(max_batch=3, max_len=96, prefill_pad=16), **kw)
    return Engine(cfg, pt, device="cpu", opts=ModelOpts(
        use_flash=True, use_flash_decode=True), **kw)


def test_engine_tokens_match_jax_engine(stack):
    """Prompt lengths that are multiples of ``prefill_pad``, so the JAX
    engine's whole prefill runs no pad through the SSM; four requests on
    three slots, so one slot is reused."""
    from repro import serving as js
    from repro.serving import Engine as JEngine
    from repro_torch import kernels
    from repro_torch import serving as ts
    cfg_j, cfg_t, pj, pt = stack
    lens = [16, 32, 16, 48]
    ej = JEngine(cfg_j, pj, max_batch=3, max_len=96, prefill_pad=16)
    et = _port_engine(cfg_t, pt)
    assert et.kv.layout == "contiguous" and not et.chunked
    kernels.reset_launch_counts()
    rj, rt = ej.serve(_requests(js, lens)), et.serve(_requests(ts, lens))
    assert not any(kernels.launch_counts().values())  # plain versions
    assert [r.tokens for r in rt] == [r.tokens for r in rj]
    assert [r.finished_reason for r in rt] == ["length"] * 4


def _model_api_tokens(cfg_j, pj, prompt, max_new):
    """The reference's greedy tokens through its model API at the prompt's
    own length: ``prefill_fn``, then ``decode_fn`` steps (jitted)."""
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    prefill = jax.jit(lambda p, t, c: jm.prefill_fn(p, cfg_j, {"tokens": t},
                                                    c))
    decode = jax.jit(lambda p, t, po, c: jm.decode_fn(p, cfg_j, t, po, c))
    lg, caches = prefill(pj, jnp.asarray(prompt[None]),
                         jm.init_caches(cfg_j, 1, 96))
    out = [int(np.asarray(lg).argmax(-1)[0])]
    for i in range(max_new - 1):
        lg, caches = decode(pj, jnp.asarray([out[-1]], jnp.int32),
                            jnp.asarray([len(prompt) + i], jnp.int32), caches)
        out.append(int(np.asarray(lg).argmax(-1)[0]))
    return out


def test_engine_other_lengths_match_model_api(stack):
    """Lengths that are no multiple of ``prefill_pad`` (2: under the conv's
    W-1; 13; 7) on two slots, the third request in a reused slot, each
    held to the reference's model API at its own length."""
    from repro_torch import serving as ts
    cfg_j, cfg_t, pj, pt = stack
    reqs = _requests(ts, [2, 13, 7])
    res = _port_engine(cfg_t, pt, max_batch=2).serve(reqs)
    for r, q in zip(res, reqs):
        assert r.tokens == _model_api_tokens(cfg_j, pj, q.prompt, 5), r.uid


def _logit_rows(eng):
    """Record the slot-0 logits row of every whole prefill and decode step
    of a one-slot engine (a list, filled as it serves)."""
    rows = []
    prefill, decode = eng.runner.whole_prefill, eng.runner.decode

    def rec(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            rows.append(out[0][0].clone())
            return out
        return call
    eng.runner.whole_prefill, eng.runner.decode = rec(prefill), rec(decode)
    return rows


def test_reused_slot_matches_solo(stack):
    """One slot: a 48-token request leaves its conv and SSM state in the
    slot, and the next request there must start from zeros -- its tokens,
    and the logits of its prefill and every decode step, equal the same
    request's alone on a fresh engine (a stale state moves the logits of
    these small random models too little to flip a greedy token)."""
    from repro_torch import serving as ts
    cfg_j, cfg_t, pj, pt = stack
    first, second = _requests(ts, [48, 2], max_new=6)
    eng = _port_engine(cfg_t, pt, max_batch=1)
    rows = _logit_rows(eng)
    eng.submit(first)
    eng.submit(second)
    eng.step()                      # the first request holds the slot
    assert all(bool(c["state"].abs().sum() > 0) for c in eng.kv.caches
               if "state" in c)
    done = {r.uid: r for r in eng.drain()}
    solo_eng = _port_engine(cfg_t, pt, max_batch=1)
    solo_rows = _logit_rows(solo_eng)
    solo = solo_eng.serve([second])
    assert done[second.uid].tokens == solo[0].tokens
    assert len(rows) == 12 and len(solo_rows) == 6
    for got, want in zip(rows[6:], solo_rows):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)


def test_engine_refuses_what_the_reference_refuses(stack):
    from repro import models as jm
    from repro.serving import Engine as JEngine
    from repro_torch import serving as ts
    cfg_j, cfg_t, pj, pt = stack
    cases = [dict(cache_layout="paged"), dict(prefill_chunk=16),
             dict(prefix_cache=True), dict(router_lookahead=True)]
    for kw in cases:
        with pytest.raises(ValueError):
            JEngine(cfg_j, pj, max_batch=2, max_len=64, **kw)
        with pytest.raises(ValueError):
            _port_engine(cfg_t, pt, max_batch=2, max_len=64, **kw)
    with pytest.raises(ValueError):
        JEngine(cfg_j, pj, max_batch=2, max_len=64,
                opts=jm.ModelOpts(router_lookahead=True))
    # a prompt over one SSD chunk that is no multiple of it: rejected
    res = _port_engine(cfg_t, pt).serve(_requests(ts, [20, 32]))
    assert [r.finished_reason for r in res] == ["rejected_ragged_prompt",
                                                "length"]


def test_lexi_refuses_a_config_without_moe(stack):
    from repro_torch.core import optimize, profile_sensitivity
    cfg_j, cfg_t, pj, pt = stack
    with pytest.raises(ValueError, match="no MoE layers"):
        profile_sensitivity(pt, cfg_t, device="cpu")
    with pytest.raises(ValueError, match="no MoE layers"):
        optimize(pt, cfg_t, 4, device="cpu")


@pytest.mark.parametrize("stack", ["zamba2-1.2b"], indirect=True)
def test_convert_round_trips_shared_params(stack):
    """The reference's own init and train state through ``convert_params``
    / ``convert_train_state`` and back: the shared block once, at the top
    of the port's params; its loss equals the reference's on them."""
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro.optim import AdamW as JAdamW
    from repro.training.step import init_state as jinit_state
    from repro_torch import models as tm
    from repro_torch.convert import convert_params, convert_train_state
    cfg_j, cfg_t, _, _ = stack
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda k: jm.init_params(k, cfg_j))(jax.random.PRNGKey(3)))
    pt = convert_params(ref, cfg_t, device="cpu")
    assert pt["layers"][1] == {} and pt["layers"][3] == {}
    assert "shared_attn" not in pt["layers"][0]
    _assert_trees_close(reference_params(pt, cfg_t), ref, rtol=0, atol=0)
    batch = _batch(cfg_t)
    lj, _ = jax.jit(lambda p, b_: jm.loss_fn(p, cfg_j, b_))(
        ref, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        lt, _ = tm.loss_fn(pt, cfg_t, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    np.testing.assert_allclose(lt.item(), float(lj), **TOL)

    st = jax.tree.map(np.asarray, jax.jit(lambda k: jinit_state(
        k, cfg_j, JAdamW(), compression=True))(jax.random.PRNGKey(3)))
    stt = convert_train_state(st, cfg_t, device="cpu")
    assert stt.opt.step == int(st.opt.step)
    for got, want in ((stt.params, st.params), (stt.opt.mu, st.opt.mu),
                      (stt.opt.nu, st.opt.nu), (stt.err, st.err)):
        _assert_trees_close(reference_params(got, cfg_t), want, rtol=0,
                            atol=0)


@pytest.mark.parametrize("stack", ["zamba2-1.2b"], indirect=True)
def test_compression_scales_as_the_reference(stack):
    """The reference's ``compress_grads`` on its tree (zamba2's pattern
    alternates mamba and shared_attn, so every group is one layer, and the
    shared block's one set is scaled once) against the port's on the same
    grads: one scale per leaf of the reference's tree, equal up to a
    quantum where ``g / scale`` rounds either way."""
    import jax
    from repro.optim.compression import compress_grads as jcompress
    from repro_torch.convert import convert_params
    from repro_torch.optim.compression import compress_grads, \
        compression_bytes_saved, scale_groups
    from repro_torch.tree import flatten_with_paths, leaves, unflatten
    cfg_j, cfg_t, pj, pt = stack
    _, _, gt = _port_grads(pt, cfg_t, _batch(cfg_t))
    grads = reference_params(gt, cfg_t)
    rng = np.random.default_rng(3)
    err = jax.tree.map(
        lambda g: 1e-3 * rng.standard_normal(g.shape).astype(np.float32),
        grads)
    deq_j, err2_j = jax.tree.map(np.asarray, jax.jit(jcompress)(grads, err))
    groups = scale_groups(gt, cfg_t)
    assert len(groups) == len(jax.tree.leaves(grads))
    conv = lambda t: dict(flatten_with_paths(
        convert_params(t, cfg_t, device="cpu")))
    quantum = conv(jax.tree.map(
        lambda d: np.full(d.shape, np.abs(d).max() / 127, np.float32), deq_j))
    # the error state in the port's leaf order (``convert_params`` keeps
    # the reference's key order)
    err_t = conv(err)
    err_t = unflatten(gt, [err_t[k] for k, _ in flatten_with_paths(gt)])
    deq_t, err2_t = compress_grads(gt, err_t, cfg_t)
    for got, want in ((deq_t, conv(deq_j)), (err2_t, conv(err2_j))):
        got = dict(flatten_with_paths(got))
        assert got.keys() == want.keys()
        for key, g in got.items():
            off = np.abs(g.numpy() - want[key].numpy())
            assert (off <= 1.001 * quantum[key].numpy() + 1e-12).all(), key
    n = sum(int(t.numel()) for t in leaves(gt))
    assert compression_bytes_saved(gt, cfg_t) == n * 4 - (n + 4 * len(groups))
