"""The encoder-decoder (whisper-base) against the JAX reference on the CPU.

At ``.reduced()`` widths (d_model 128, 4 heads of 32, f32), 2 encoder and
2 decoder layers over 32 stub frames, LayerNorm with a bias.  The port's
own init is given to the reference as its tree (``enc_layers`` and
``dec_layers`` are plain lists in both).

* ``loss_fn`` and every gradient within 1e-4 of the reference's.
* The reference's prefill-then-decode consistency, port against reference,
  and greedy decode steps reading the cross K/V from the cache.
* ``convert_params`` / ``convert_train_state`` round-trip the reference's
  own init and train state.
* Paged caches, chunked prefill and the engine are refused (the reference
  engine cannot serve it either: its prefill passes no frames).
* ``make_train_batch`` and the data stream carry frames.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_ref import reference_params  # noqa: E402
from _torch_threads import one_thread  # noqa: F401,E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def whisper():
    """(cfg_j, cfg_t, reference params, the port's params)."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    from repro_torch.models import init_params
    cfg_j = jget("whisper-base").reduced().with_(num_layers=2)
    cfg_t = tget("whisper-base").reduced().with_(num_layers=2)
    assert cfg_t.norm_type == "layernorm" and cfg_t.encoder_layers == 2
    pt = init_params(cfg_t, 0, device="cpu")
    return cfg_j, cfg_t, reference_params(pt, cfg_t), pt


def _batch(cfg, b=2, s=16, seed=4):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "mask": (rng.random((b, s)) > 0.2).astype(np.int32),
            "frames": rng.standard_normal(
                (b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)}


def _close(got, want, **tol):
    from repro_torch.tree import flatten_with_paths
    got, want = dict(flatten_with_paths(got)), dict(flatten_with_paths(want))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   err_msg=k, **tol)


def test_loss_and_grads_match_reference(whisper):
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro_torch import models as tm
    from repro_torch.tree import map_tree
    cfg_j, cfg_t, pj, pt = whisper
    batch = _batch(cfg_t)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p, b_: jm.loss_fn(p, cfg_j, b_), has_aux=True))(
            pj, {k: jnp.asarray(v) for k, v in batch.items()})
    p = map_tree(lambda t: t.detach().clone().requires_grad_(), pt)
    lt, mt = tm.loss_fn(p, cfg_t, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), **TOL)
    np.testing.assert_allclose(mt["xent"].item(), float(mj["xent"]), **TOL)
    assert mt["aux"].item() == 0.0
    _close(reference_params(map_tree(lambda t: t.grad, p), cfg_t),
           jax.tree.map(np.asarray, gj), **TOL)


def test_prefill_and_decode_match_reference(whisper):
    """Prefill of S-1 tokens over the frames, then four decode steps (the
    first on the batch's last token, then greedy) reading the cross K/V
    from the caches; and the reference test's own claim on the port: the
    prefill and first decode logits equal a train-mode decoder pass."""
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro_torch import models as tm
    from repro_torch.models import encdec as ted
    cfg_j, cfg_t, pj, pt = whisper
    b, s = 2, 16
    batch = _batch(cfg_t, b, s)
    tok, frames = batch["tokens"], batch["frames"]
    cj = jm.init_caches(cfg_j, b, 64)
    lj, cj = jax.jit(lambda p, f, t, c: jm.prefill_fn(
        p, cfg_j, {"frames": f, "tokens": t}, c))(
            pj, jnp.asarray(frames), jnp.asarray(tok[:, :-1]), cj)
    ct = tm.init_caches(cfg_t, b, 64, device="cpu")
    lt, ct = tm.prefill_fn(pt, cfg_t, {"frames": torch.from_numpy(frames),
                                       "tokens": torch.from_numpy(tok[:, :-1])},
                           ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    first = [lt.numpy()]
    jdecode = jax.jit(lambda p, t, po, c: jm.decode_fn(p, cfg_j, t, po, c))
    nxt = tok[:, -1]
    for i in range(4):
        pos = np.full((b,), s - 1 + i, np.int32)
        lj, cj = jdecode(pj, jnp.asarray(nxt), jnp.asarray(pos), cj)
        lt, ct = tm.decode_fn(pt, cfg_t, torch.from_numpy(nxt),
                              torch.from_numpy(pos), ct)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        first.append(lt.numpy())
        nxt = lt.numpy().argmax(-1).astype(np.int32)
    with torch.no_grad():
        enc = ted.encode(pt, cfg_t, torch.from_numpy(frames))
        pos = torch.arange(s, dtype=torch.int32).expand(b, s)
        full, _ = ted._decoder(pt, cfg_t, torch.from_numpy(tok), pos, "train",
                               None, enc, tm.DEFAULT_OPTS)
    np.testing.assert_allclose(first[0], full[:, -2].numpy(), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(first[1], full[:, -1].numpy(), rtol=2e-3,
                               atol=2e-3)


def test_convert_round_trips_the_references_tree(whisper):
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro.optim import AdamW as JAdamW
    from repro.training.step import init_state as jinit_state
    from repro_torch import models as tm
    from repro_torch.convert import convert_params, convert_train_state
    cfg_j, cfg_t, _, _ = whisper
    st = jax.tree.map(np.asarray, jax.jit(lambda k: jinit_state(
        k, cfg_j, JAdamW(), compression=True))(jax.random.PRNGKey(5)))
    pt = convert_params(st.params, cfg_t, device="cpu")
    assert len(pt["enc_layers"]) == 2 and len(pt["dec_layers"]) == 2
    assert set(pt["dec_layers"][0]) == {"norm1", "attn", "norm_x", "xattn",
                                        "norm2", "mlp"}
    assert set(pt["enc_norm"]) == {"scale", "bias"}
    _close(reference_params(pt, cfg_t), st.params, rtol=0, atol=0)
    batch = _batch(cfg_t)
    lj, _ = jax.jit(lambda p, b_: jm.loss_fn(p, cfg_j, b_))(
        st.params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        lt, _ = tm.loss_fn(pt, cfg_t, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    np.testing.assert_allclose(lt.item(), float(lj), **TOL)
    stt = convert_train_state(st, cfg_t, device="cpu")
    assert stt.opt.step == int(st.opt.step)
    for got, want in ((stt.params, st.params), (stt.opt.mu, st.opt.mu),
                      (stt.opt.nu, st.opt.nu), (stt.err, st.err)):
        _close(reference_params(got, cfg_t), want, rtol=0, atol=0)


def test_refusals(whisper):
    from repro import models as jm
    from repro_torch import models as tm
    from repro_torch.serving import Engine
    cfg_j, cfg_t, pj, pt = whisper
    with pytest.raises(NotImplementedError, match="paged KV"):
        jm.init_caches(cfg_j, 2, 64, layout="paged", num_pages=8)
    with pytest.raises(NotImplementedError, match="paged KV"):
        tm.init_caches(cfg_t, 2, 64, layout="paged", num_pages=8,
                       device="cpu")
    tok = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="chunked prefill"):
        tm.chunk_prefill_fn(pt, cfg_t, tok, tok, None)
    with pytest.raises(ValueError, match="encoder-decoder"):
        Engine(cfg_t, pt, device="cpu")


def test_batches_carry_frames(whisper):
    from repro_torch.data import data_config_for, sample_batch
    from repro_torch.models import make_train_batch
    cfg_j, cfg_t, pj, pt = whisper
    gen = torch.Generator().manual_seed(0)
    b = make_train_batch(cfg_t, gen, 2, 8, device="cpu")
    assert b["frames"].shape == (2, cfg_t.encoder_seq_len, cfg_t.d_model)
    assert b["frames"].dtype == torch.float32
    dc = data_config_for(cfg_t, seq_len=8, global_batch=2)
    one, two = sample_batch(dc, 3), sample_batch(dc, 3)
    assert one["frames"].shape == (2, cfg_t.encoder_seq_len, cfg_t.d_model)
    assert np.array_equal(one["frames"], two["frames"])
    # the token stream is the one without frames
    plain = sample_batch(dc.__class__(dc.vocab_size, 8, 2), 3)
    assert np.array_equal(one["tokens"], plain["tokens"])
