"""Router lookahead in the port against the JAX reference.

* ``route_lookahead``: the port's ids equal the reference's on the same
  numpy inputs (softmax and sigmoid routers).
* The staged gather of the plain routed-expert paths (``moe_decode_plain``,
  ``moe_decode_quant_plain`` in int8 and int4) with planted partial hits is
  bitwise the plain gather's output.
* ``decode_fn`` with the hint on equals itself with it off, bitwise, and
  the reference's ``decode_fn`` with ``router_lookahead=True`` within the
  f32 tolerance of the other port tests.
* An engine with ``router_lookahead=True`` serves the greedy tokens of the
  reference's engine with it on, and of its own with it off (bf16 and int8
  experts).  ``launch/serve.py --router-lookahead`` runs on the CPU.
* On the card (skipped elsewhere): the kernels ignore the hint, B3 and B5
  give bitwise the same output with and without it.

Tiny f32 configs on ``gmm`` with the fused decode path; the JAX engines
block on each step (``_synchronous``: its CPU block table is updated in
place while an asynchronous step may still read it).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402


#: f32 logits through a few layers, products summed in another order
TOL = dict(rtol=1e-4, atol=1e-4)


def _synchronous(engine):
    """Block on each of the JAX engine's device steps before it goes on."""
    import jax
    for name in ("chunk_prefill", "decode"):
        fn = getattr(engine.runner, name)
        setattr(engine.runner, name,
                lambda *a, fn=fn, **kw: jax.block_until_ready(fn(*a, **kw)))
    return engine


@pytest.fixture(scope="module")
def model():
    """A 3-layer OLMoE cut (8 experts, top-2, f32, gmm) on the reference's
    weights, converted."""
    import jax
    from repro import models as jm
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    from repro_torch.convert import convert_params
    kw = dict(num_layers=3, d_model=64, num_heads=2, num_kv_heads=2,
              head_dim=32, num_experts=8, moe_top_k=2, moe_d_ff=64,
              vocab_size=128, vocab_pad_multiple=16, dtype="float32",
              moe_impl="gmm")
    cfg_j = jget("olmoe-1b-7b").reduced().with_(**kw)
    cfg_t = tget("olmoe-1b-7b").reduced().with_(**kw)
    pj = jax.jit(lambda k: jm.init_params(k, cfg_j))(jax.random.PRNGKey(0))
    pt = convert_params(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


@pytest.mark.parametrize("router_type", ["softmax", "sigmoid"])
def test_route_lookahead_ids_match_reference(router_type):
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models.moe.router import route_lookahead as jlook
    from repro_torch.configs import get_config as tget
    from repro_torch.models.moe import route, route_lookahead
    kw = dict(d_model=32, num_experts=16, moe_top_k=4,
              router_type=router_type, dtype="float32")
    cfg_j = jget("olmoe-1b-7b").reduced().with_(**kw)
    cfg_t = tget("olmoe-1b-7b").reduced().with_(**kw)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(24, 32)).astype(np.float32)
    # router weights at the init's scale: large logits saturate sigmoid
    # scores to exact ties, which the two libraries break differently
    router = (0.1 * rng.normal(size=(32, 16))).astype(np.float32)
    want = np.asarray(jlook({"router": jnp.asarray(router)}, cfg_j,
                            jnp.asarray(x), 4))
    p = {"router": torch.from_numpy(router)}
    got = route_lookahead(p, cfg_t, torch.from_numpy(x), 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the same selection as route's on the same input
    assert torch.equal(got, route(p, cfg_t, torch.from_numpy(x), 4)[1])


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_staged_gather_is_the_plain_gather_bitwise(dtype):
    from repro_torch.kernels.moe_decode import _gather, \
        moe_decode_plain, moe_decode_quant_plain
    from repro_torch.models.moe import quantize_experts
    b, k, e, d, f = 6, 3, 8, 64, 32
    g = torch.Generator().manual_seed(5)
    x = torch.randn(b, d, generator=g)
    w1 = torch.randn(e, d, 2 * f, generator=g) * 0.05
    w2 = torch.randn(e, f, d, generator=g) * 0.05
    idx = torch.randint(0, e, (b, k), generator=g).int()
    w = torch.rand(b, k, generator=g)
    pred = idx.clone()
    miss = torch.rand(b, k, generator=g) < 0.5     # planted misses
    pred[miss] = (idx[miss] + 1 + torch.randint(0, e - 1, (int(miss.sum()),),
                                                generator=g).int()) % e
    assert 0 < int((pred == idx).sum()) < b * k      # partial hits
    assert torch.equal(_gather(w1, idx, pred), w1[idx.long()])
    if dtype == "bf16":
        got = moe_decode_plain(x, w1, w2, idx, w, pred)
        want = moe_decode_plain(x, w1, w2, idx, w)
    else:
        q = quantize_experts(w1, w2, dtype)
        got = moe_decode_quant_plain(x, *q, idx, w, dtype=dtype,
                                     pred_idx=pred)
        want = moe_decode_quant_plain(x, *q, idx, w, dtype=dtype)
    assert torch.equal(got, want)


def test_decode_logits_with_hint_match_off_and_reference(model):
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro_torch import models as tm
    cfg_j, cfg_t, pj, pt = model
    rng = np.random.default_rng(0)
    b, c, p, n = 2, 8, 16, 5
    bt = np.array([[1, 2], [3, 4]], np.int32)
    tok = rng.integers(0, cfg_j.vocab_size, (b, c)).astype(np.int32)
    pos = np.arange(c)[None].repeat(b, 0).astype(np.int32)
    last = np.full(b, c - 1, np.int32)
    cj = jm.init_caches(cfg_j, b, 32, layout="paged", page_size=p,
                        num_pages=n)
    _, cj = jax.jit(lambda p_, t, po, c_, li, bt_: jm.chunk_prefill_fn(
        p_, cfg_j, t, po, c_, last_index=li, block_tables=bt_))(
            pj, jnp.asarray(tok), jnp.asarray(pos), cj, jnp.asarray(last),
            jnp.asarray(bt))
    ct = tm.init_caches(cfg_t, layout="paged", page_size=p,
                        num_pages=n, device="cpu")
    _, ct = tm.chunk_prefill_fn(pt, cfg_t, torch.from_numpy(tok),
                                torch.from_numpy(pos), ct,
                                last_index=torch.from_numpy(last),
                                block_tables=torch.from_numpy(bt))
    nxt = rng.integers(0, cfg_j.vocab_size, b).astype(np.int32)
    pos1 = np.full(b, c, np.int32)
    jopts = jm.ModelOpts(use_moe_decode_kernel=True, router_lookahead=True)
    want, _ = jax.jit(lambda p_, t, po, c_, bt_: jm.decode_fn(
        p_, cfg_j, t, po, c_, block_tables=bt_, opts=jopts))(
            pj, jnp.asarray(nxt), jnp.asarray(pos1), cj, jnp.asarray(bt))
    got = {}
    for on in (False, True):
        opts = tm.ModelOpts(use_moe_kernel=True, use_moe_decode_kernel=True,
                            router_lookahead=on)
        # each call on its own copy: a decode step writes the pool
        cc = [{n_: t.clone() for n_, t in layer.items()} for layer in ct]
        got[on], _ = tm.decode_fn(pt, cfg_t, torch.from_numpy(nxt),
                                  torch.from_numpy(pos1), cc,
                                  block_tables=torch.from_numpy(bt),
                                  opts=opts)
    assert torch.equal(got[True], got[False])
    np.testing.assert_allclose(got[True].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("expert_dtype", ["bf16", "int8"])
def test_engine_tokens_with_lookahead_match_reference_and_off(model,
                                                              expert_dtype):
    from repro import serving as js
    from repro_torch import serving as ts
    cfg_j, cfg_t, pj, pt = model
    common = dict(max_batch=2, max_len=64, prefill_chunk=8, page_size=8,
                  use_moe_decode=True, expert_dtype=expert_dtype)

    def reqs(mod):
        rng = np.random.default_rng(3)
        return [mod.Request(uid=i, prompt=rng.integers(
            0, 128, rng.integers(5, 14)).astype(np.int32), max_new_tokens=6)
            for i in range(3)]
    ej = _synchronous(js.Engine(cfg_j, pj, router_lookahead=True, **common))
    want = [r.tokens for r in ej.serve(reqs(js))]
    for on in (True, False):
        et = ts.Engine(cfg_t, pt, router_lookahead=on, device="cpu",
                       **common)
        assert et.router_lookahead is on
        assert et.runner.opts.router_lookahead is on
        assert [r.tokens for r in et.serve(reqs(ts))] == want, on


def test_serve_launcher_router_lookahead_flag(capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                 "--requests", "2", "--max-new", "4", "--max-len", "64",
                 "--max-batch", "2", "--moe-impl", "gmm",
                 "--use-moe-decode", "--router-lookahead"]) == 0
    out = capsys.readouterr().out
    assert "lookahead=True" in out and "baseline:" in out


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present, decided when the
    test runs (never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")


@pytest.mark.parametrize("dtype", ["bf16", "int8", "int4"])
def test_decode_kernels_ignore_the_hint_on_card(card, dtype):
    from repro_torch.kernels import moe_decode, moe_decode_quant
    from repro_torch.models.moe import quantize_experts
    b, k, e, d, f = 8, 8, 16, 256, 192
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(b, d, generator=g, device="cuda").bfloat16()
    w1 = (torch.randn(e, d, 2 * f, generator=g, device="cuda") * 0.05)
    w2 = (torch.randn(e, f, d, generator=g, device="cuda") * 0.05)
    idx = torch.randint(0, e, (b, k), generator=g, device="cuda").int()
    pred = torch.randint(0, e, (b, k), generator=g, device="cuda").int()
    w = torch.rand(b, k, generator=g, device="cuda")
    if dtype == "bf16":
        args = (x, w1.bfloat16(), w2.bfloat16(), idx, w)
        assert torch.equal(moe_decode(*args, pred), moe_decode(*args))
    else:
        q = quantize_experts(w1, w2, dtype)
        args = (x, *q, idx, w)
        assert torch.equal(moe_decode_quant(*args, pred, dtype=dtype),
                           moe_decode_quant(*args, dtype=dtype))
