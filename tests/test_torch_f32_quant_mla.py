"""The rest of the reference kernels' float32 contract on the port: B5
``moe_decode_quant`` and B6 ``moe_gmm_quant`` take f32 activations (their
Pallas references take any float x and write x's dtype), and B7
``flash_decode_paged_mla`` takes f32 latent pools, also at the reduced
DeepSeek config's (r 32, dr 16) (its reference casts its latents to f32).

* On ``meta`` (the card route's checks and costs, no launch): f32
  activations and f32 latents are taken, the output is f32, and the
  launch's cost counts each float element at 4 bytes; B7 refuses a latent
  pool that mixes bf16 and f32, and bf16 latents at (32, 16); B5 and B6
  refuse activations of another float dtype.
* The f32 plain versions (the wrappers on CPU tensors) against the
  reference's Pallas kernels in interpret mode (and B7's gather-form
  oracle), on inputs not exact in bf16, at the reference's f32 tolerance
  ``rtol=atol=2e-5``.
* ``launch/serve_lexi.py`` with quantized experts keeps its kernels on.
* Card tests (skipped without a GPU): each new f32 instance against its
  plain version at ``rtol=atol=2e-5``, at the reduced shapes and at full
  width; B6's counted rows as B1's (``counted_rows_on_card``); B7's rows
  bitwise alone and in a batch at a wider table view.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402
from test_torch_f32_kernels import GMM_F32_CARD, \
    counted_rows_on_card  # noqa: E402
from test_torch_mla import latent_pool  # noqa: E402

#: the reference's f32 tolerance for its kernels (tests/test_kernels.py)
TOL = dict(rtol=2e-5, atol=2e-5)
F32 = torch.float32
BF16 = torch.bfloat16
I32 = torch.int32
QUANT = ("int8", "int4")


def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _qweights(e, d, f, dtype, device="meta"):
    """int8 w1q [E, D(p), 2F], w2q [E, F, D(p)] (int4: D(p) = D/2) and the
    f32 scales s1 [E, 2, F], s2 [E, F]."""
    dp = d // 2 if dtype == "int4" else d
    mk = (lambda *s, dtype: torch.empty(s, dtype=dtype, device=device))
    return (mk(e, dp, 2 * f, dtype=torch.int8), mk(e, f, dp, dtype=torch.int8),
            mk(e, 2, f, dtype=F32), mk(e, f, dtype=F32))


def _quant_bytes(experts, d, f, dtype):
    per = 3 * d * f if dtype == "int8" else 3 * d * f // 2
    return experts * (per + 3 * f * 4)


# --------------------------------------------------------------------------- #
# meta: f32 taken, outputs f32, costs at 4 bytes
# --------------------------------------------------------------------------- #


def _quant_case(name, dtype, dt):
    """(wrapper, args, kwargs, (flops, bytes) by hand) at small shapes: D
    128 (int4's stored D/2 a multiple of 64), F 32, 4 experts."""
    from repro_torch import kernels as K
    es = torch.empty((), dtype=dt).element_size()
    e, d, f, b, k, m, bm = 4, 128, 32, 2, 2, 16, 8
    q = _qweights(e, d, f, dtype)
    if name == "moe_decode_quant":
        # 4 slots: at most the 4 experts
        return (K.moe_decode_quant,
                (_meta(b, d, dtype=dt), *q, _meta(b, k, dtype=I32),
                 _meta(b, k)), {"dtype": dtype},
                (b * k * 6 * d * f, es * 2 * b * d
                 + _quant_bytes(4, d, f, dtype) + b * k * 8))
    # 2 tiles: at most 2 of the 4 experts
    return (K.moe_gmm_quant,
            (_meta(m, d, dtype=dt), *q, _meta(m // bm, dtype=I32),
             _meta(m // bm, dtype=I32)), {"dtype": dtype, "block_m": bm},
            (m * 6 * d * f, es * 2 * m * d + _quant_bytes(2, d, f, dtype)
             + 2 * 2 * 4))


@pytest.mark.parametrize("name", ["moe_decode_quant", "moe_gmm_quant"])
@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("dt", [F32, BF16], ids=["f32", "bf16"])
def test_meta_quant_takes_f32_activations(name, dtype, dt):
    """B5 and B6 take bf16 or f32 activations on the card route's checks;
    the output has the activations' dtype and the reported cost counts
    each activation element at its own size (int8 / int4 weights and f32
    scales as before)."""
    from repro_torch import kernels as K
    from repro_torch.analysis.counters import count
    wrapper, args, kw, (flops, nbytes) = _quant_case(name, dtype, dt)
    before = K.launch_counts()
    with count() as c:
        got = wrapper(*args, **kw)
    assert K.launch_counts() == before
    assert got.is_meta and got.dtype == dt and got.shape == args[0].shape
    assert c.kernel_calls == {name: 1}
    assert (c.kernel_flops, c.kernel_bytes) == (flops, nbytes)


@pytest.mark.parametrize("name", ["moe_decode_quant", "moe_gmm_quant"])
def test_quant_activations_of_another_float_dtype_raise(name):
    """Only bf16 and f32 activations: fp16 is refused, never cast."""
    wrapper, args, kw, _ = _quant_case(name, "int8", F32)
    with pytest.raises(TypeError, match="bfloat16 or torch.float32"):
        wrapper(args[0].to(torch.float16), *args[1:], **kw)


def test_moe_decode_quant_f32_shared_memory_counts_4_bytes():
    """Pass 1 stages x rows at the element's size: at llama4-scout's D
    5120 the f32 stage is twice the bf16 one and still fits a block."""
    from repro_torch.kernels.moe_decode import SMEM_MAX, quant_smem
    bf = quant_smem(8, 5120, 8192, "int8")
    f32 = quant_smem(8, 5120, 8192, "int8", 4)
    assert f32[0] - bf[0] == 5120 * 8 * 2 and f32[1] == bf[1]
    assert max(f32) <= SMEM_MAX


def _mla_args(r, dr, lat, h=4, b=2, n=6, p=4, nb=3):
    return (_meta(b, h, r), _meta(b, h, dr), _meta(n, p, r, dtype=lat),
            _meta(n, p, dr, dtype=lat), _meta(n, p, dtype=I32),
            _meta(b, nb, dtype=I32), _meta(b, dtype=I32))


@pytest.mark.parametrize("lat,r,dr", [
    (F32, 512, 64), (F32, 256, 32), (F32, 32, 16), (BF16, 512, 64),
    (BF16, 256, 32)], ids=["f32-512", "f32-256", "f32-32", "bf16-512",
                           "bf16-256"])
def test_meta_mla_takes_the_latent_dtype_and_counts_its_bytes(lat, r, dr):
    """B7 on f32 latents at all three (r, dr) and bf16 at its two: the
    output is f32 and the cost counts each latent at its own size."""
    from repro_torch import kernels as K
    from repro_torch.analysis.counters import count
    h, b, n, p, nb = 4, 2, 6, 4, 3
    es = torch.empty((), dtype=lat).element_size()
    args = _mla_args(r, dr, lat, h, b, n, p, nb)
    with count() as c:
        got = K.flash_decode_paged_mla(*args, scale=0.1)
    assert got.is_meta and got.dtype == F32 and got.shape == (b, h, r)
    slots = b * nb * p
    assert c.kernel_calls == {"flash_decode_paged_mla": 1}
    assert c.kernel_flops == slots * h * (2 * (r + dr) + 2 * r)
    assert c.kernel_bytes == (2 * b * h * r * 4 + b * h * dr * 4
                              + slots * ((r + dr) * es + 4) + b * nb * 4
                              + b * 4)


def test_mla_refuses_a_latent_mix_and_bf16_at_32_16():
    """The two latent pools share one dtype; bf16 latents keep their two
    (r, dr) pairs."""
    from repro_torch import kernels as K
    args = list(_mla_args(32, 16, F32))
    mixed = list(args)
    mixed[3] = mixed[3].to(BF16)
    with pytest.raises(TypeError, match="kropep"):
        K.flash_decode_paged_mla(*mixed, scale=0.1)
    mixed = list(args)
    mixed[2] = mixed[2].to(BF16)
    with pytest.raises(TypeError, match="kropep"):
        K.flash_decode_paged_mla(*mixed, scale=0.1)
    with pytest.raises(ValueError, match="no kernel"):
        K.flash_decode_paged_mla(*_mla_args(32, 16, BF16), scale=0.1)
    with pytest.raises(ValueError, match="no kernel"):
        K.flash_decode_paged_mla(*_mla_args(64, 16, F32), scale=0.1)


# --------------------------------------------------------------------------- #
# the f32 plain versions against the Pallas kernels
# --------------------------------------------------------------------------- #


def _np(x):
    return np.asarray(x, np.float32)


def _f32_experts(rng, e, d, f, dtype):
    """The port's quantization of weights at the model's init scale."""
    from repro_torch.models.moe import quantize_experts
    w1 = (rng.normal(size=(e, d, 2 * f)) / d ** 0.5).astype(np.float32)
    w2 = (rng.normal(size=(e, f, d)) / f ** 0.5).astype(np.float32)
    return quantize_experts(torch.from_numpy(w1), torch.from_numpy(w2), dtype)


@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("b,k,e", [(8, 2, 8), (3, 4, 6)])
def test_moe_decode_quant_f32_matches_pallas(dtype, b, k, e):
    """The reduced configs' widths (D 128, F 64), f32 x not exact in
    bf16, a repeated expert and a zero weight."""
    import jax.numpy as jnp
    from repro.kernels.moe_decode import moe_decode_quant_pallas
    from repro_torch.kernels import moe_decode_quant
    rng = np.random.default_rng(b * 7 + k + e)
    d, f = 128, 64
    q = _f32_experts(rng, e, d, f, dtype)
    x = rng.normal(size=(b, d)).astype(np.float32)
    idx = rng.integers(0, e, size=(b, k)).astype(np.int32)
    idx[0, 1] = idx[0, 0]
    w = rng.random((b, k)).astype(np.float32)
    w[-1, -1] = 0.0
    got = moe_decode_quant(torch.from_numpy(x), *q, torch.from_numpy(idx),
                           torch.from_numpy(w), dtype=dtype)
    assert got.dtype == F32
    want = moe_decode_quant_pallas(
        *(jnp.asarray(a) for a in (x, *(t.numpy() for t in q), idx, w)),
        dtype=dtype, block_f=32, interpret=True)
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


#: (tokens, k, experts, block_m, a token set to all zero (its copies are
#: real rows that are all zero) or None, padding rows of the first padded
#: expert set nonzero): the dispatch's layout, and the layouts the f32
#: kernel's row count meets -- tiles of 64 and 128 rows holding a few, an
#: all-zero real row, padding rows a caller left nonzero; the first two
#: ids as before
GMM_QUANT_F32_LAYOUTS = [
    ((12, 2, 8, 8, None, 0), "12-2-8-8"),
    ((40, 2, 8, 16, None, 0), "40-2-8-16"),
    ((20, 2, 8, 64, None, 0), "bm64-few-rows"),
    ((24, 1, 4, 128, 5, 0), "bm128-zero-row"),
    ((16, 2, 6, 128, None, 3), "bm128-nonzero-padding"),
]


@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("t,k,e,bm,zero,pad",
                         [c for c, _ in GMM_QUANT_F32_LAYOUTS],
                         ids=[i for _, i in GMM_QUANT_F32_LAYOUTS])
def test_moe_gmm_quant_f32_matches_pallas(dtype, t, k, e, bm, zero, pad):
    """The sorted dispatch of f32 tokens at D 128, F 64; h stays f32 on
    both sides."""
    import jax.numpy as jnp
    from repro.kernels.moe_gmm import moe_gmm_quant_pallas
    from repro_torch.kernels import moe_gmm_quant
    from repro_torch.models.moe import make_sort_plan, sort_dispatch
    rng = np.random.default_rng(t + e)
    d, f = 128, 64
    q = _f32_experts(rng, e, d, f, dtype)
    idx = np.stack([rng.permutation(e - 1)[:k]
                    for _ in range(t)]).astype(np.int32)
    plan = make_sort_plan(torch.from_numpy(idx), e, bm)
    x = rng.normal(size=(t, d)).astype(np.float32)
    if zero is not None:
        x[zero] = 0.0
    xs = sort_dispatch(torch.from_numpy(x), plan, k)
    if pad:
        sizes = plan.group_sizes.numpy()
        padded = plan.padded_group_sizes.numpy()
        ei = int(np.flatnonzero(padded > sizes)[0])
        r0 = int(padded[:ei].sum() + sizes[ei])
        xs[r0:r0 + pad] = torch.from_numpy(
            rng.normal(size=(pad, d)).astype(np.float32))
    got = moe_gmm_quant(xs, *q, plan.tile_expert, plan.tile_valid,
                        dtype=dtype, block_m=bm)
    assert got.dtype == F32
    want = moe_gmm_quant_pallas(
        jnp.asarray(xs.numpy()), *(jnp.asarray(a.numpy()) for a in q),
        jnp.asarray(plan.tile_expert.numpy()),
        jnp.asarray(plan.tile_valid.numpy()), dtype=dtype, block_m=bm,
        block_f=32, interpret=True)
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


#: the model's qk dims (dn + dr) for B7's scale, by latent width r: the
#: reduced DeepSeek config's, DeepSeek-V2-Lite's and MiniCPM3-4B's
MLA_QK = {32: 16 + 16, 512: 128 + 64, 256: 64 + 32}


@pytest.mark.parametrize("lens,n_blk,live,h,r,dr", [
    # the reduced DeepSeek config's (r 32, dr 16), 4 heads
    pytest.param([96, 50, 17, 7, 1], 8, 8, 4, 32, 16,
                 id="lens0-8-8"),          # the reduced check's rows
    pytest.param([150, 20], 20, 20, 4, 32, 16,
                 id="lens1-20-20"),        # a row past the rank stride
    pytest.param([60, 33, 5], 6, 4, 4, 32, 16,
                 id="lens2-6-4"),          # a truncated live-page view
    # full width on short rows: DeepSeek-V2-Lite's 16 heads at (512, 64),
    # MiniCPM3-4B's 40 at (256, 32)
    pytest.param([40, 17, 0], 4, 4, 16, 512, 64, id="deepseek-h16"),
    pytest.param([40, 17, 0], 4, 4, 40, 256, 32, id="minicpm3-h40"),
])
def test_mla_f32_plain_matches_pallas_and_ref(lens, n_blk, live, h, r, dr):
    """B7's plain version on f32 latents (``rng.normal``, not exact in
    bf16), pages of 16, against the Pallas kernel in interpret mode and
    the reference's oracle, at the reduced config's shapes and at full
    width."""
    import jax.numpy as jnp
    from repro.kernels.flash_decode_paged import flash_decode_paged_mla_pallas
    from repro.kernels.ref import flash_decode_paged_mla_ref
    from repro_torch.kernels import flash_decode_paged_mla
    rng = np.random.default_rng(sum(lens))
    p = 16
    scale = 1.0 / MLA_QK[r] ** 0.5
    ckvp, kropep, posp, table = latent_pool(rng, lens, page_size=p,
                                             n_blk=n_blk, r=r, dr=dr)
    q_lat = rng.normal(size=(len(lens), h, r)).astype(np.float32)
    q_rope = rng.normal(size=(len(lens), h, dr)).astype(np.float32)
    cur = np.array([min(ln, live * p) - 1 for ln in lens], np.int32)
    bt = table[:, :live]
    jargs = [jnp.asarray(a) for a in (q_lat, q_rope, ckvp, kropep, posp, bt,
                                      cur)]
    want = _np(flash_decode_paged_mla_pallas(*jargs, scale=scale,
                                             interpret=True))
    ref = _np(flash_decode_paged_mla_ref(*jargs, scale=scale))
    got = flash_decode_paged_mla(
        *map(torch.from_numpy, (q_lat, q_rope, ckvp, kropep, posp)),
        torch.from_numpy(table)[:, :live], torch.from_numpy(cur),
        scale=scale)
    assert got.dtype == F32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


# --------------------------------------------------------------------------- #
# serve_lexi keeps its kernels on quantized experts
# --------------------------------------------------------------------------- #


def test_serve_lexi_runs_the_kernels_on_quantized_experts(monkeypatch):
    """``--expert-dtype int8``: the engine and the held-out eval ask for
    every kernel (on the card B6, B5, B4 and B2; the plain versions here),
    as for bf16 experts."""
    from repro_torch.launch import serve_lexi
    seen = {"engine": [], "eval": []}
    engine, evaluate = serve_lexi.Engine, serve_lexi.eval_perplexity

    class Recorded(engine):
        def __init__(self, *a, **kw):
            seen["engine"].append(kw)
            super().__init__(*a, **kw)

    def recorded(*a, opts=None, **kw):
        seen["eval"].append(opts)
        return evaluate(*a, opts=opts, **kw)
    monkeypatch.setattr(serve_lexi, "Engine", Recorded)
    monkeypatch.setattr(serve_lexi, "eval_perplexity", recorded)
    assert serve_lexi.main(["--expert-dtype", "int8", "--device", "cpu",
                            "--steps", "5", "--requests", "2",
                            "--max-new", "2"]) == 0
    assert seen["engine"] and seen["eval"]
    for kw in seen["engine"]:
        assert kw["expert_dtype"] == "int8"
        assert kw["use_kernel"] and kw["use_moe_decode"]
        assert kw["opts"].use_moe_kernel
    for opts in seen["eval"]:
        assert opts.expert_dtype == "int8"
        assert opts.use_flash and opts.use_moe_kernel


# --------------------------------------------------------------------------- #
# on the card: each new f32 instance against its plain version
# --------------------------------------------------------------------------- #


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present, decided when the
    test runs (never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")


def _f32_close(name, got, want):
    from repro_torch import kernels as K
    assert got.dtype == F32 and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)
    assert K.WRAPPERS[name].launches > 0


def _card_quant(e, d, f, dtype, seed):
    from repro_torch.models.moe import quantize_experts
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    w1 = torch.randn((e, d, 2 * f), generator=g, device="cuda") / d ** 0.5
    w2 = torch.randn((e, f, d), generator=g, device="cuda") / f ** 0.5
    return quantize_experts(w1, w2, dtype), g


@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("b,k,e,d,f", [(8, 2, 8, 128, 64), (1, 2, 8, 128, 64),
                                       (8, 8, 64, 2048, 1024),
                                       (4, 2, 16, 5120, 8192)])
def test_moe_decode_quant_f32_on_card(card, dtype, b, k, e, d, f):
    from repro_torch.kernels import moe_decode_quant
    from repro_torch.kernels.moe_decode import moe_decode_quant_plain
    q, g = _card_quant(e, d, f, dtype, b * k)
    x = torch.randn((b, d), generator=g, device="cuda")
    idx = torch.randint(0, e, (b, k), generator=g, device="cuda").int()
    w = torch.rand((b, k), generator=g, device="cuda")
    _f32_close("moe_decode_quant",
               moe_decode_quant(x, *q, idx, w, dtype=dtype),
               moe_decode_quant_plain(x, *q, idx, w, dtype=dtype))


@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("t,k,e,bm,d,f", [
    (64, 2, 8, 16, 128, 64), (37, 2, 8, 40, 128, 64),
    (512, 8, 64, 128, 2048, 1024), *GMM_F32_CARD])
def test_moe_gmm_quant_f32_on_card(card, dtype, t, k, e, bm, d, f):
    from repro_torch.kernels import moe_gmm_quant
    from repro_torch.kernels.moe_gmm import moe_gmm_quant_plain
    from repro_torch.models.moe import make_sort_plan, sort_dispatch
    q, g = _card_quant(e, d, f, dtype, t)
    x = torch.randn((t, d), generator=g, device="cuda")
    idx = torch.randint(0, e - 1, (t, k), generator=g, device="cuda").int()
    plan = make_sort_plan(idx, e, bm)
    args = (sort_dispatch(x, plan, k), *q, plan.tile_expert, plan.tile_valid)
    got = moe_gmm_quant(*args, dtype=dtype, block_m=bm)
    dead = ~plan.tile_valid.bool()
    assert (got.reshape(-1, bm, d)[dead] == 0).all()
    _f32_close("moe_gmm_quant", got,
               moe_gmm_quant_plain(*args, bm, dtype=dtype))


@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("t,k,e,bm,d,f", [(37, 2, 8, 40, 128, 64),
                                          *GMM_F32_CARD])
def test_moe_gmm_quant_f32_counted_rows_on_card(card, dtype, t, k, e, bm, d,
                                                f):
    """B6 f32 computes each tile's rows up to its last nonzero row, as B1
    f32 does (``counted_rows_on_card``)."""
    from repro_torch.kernels import moe_gmm_quant
    from repro_torch.kernels.moe_gmm import moe_gmm_quant_plain
    from repro_torch.models.moe import make_sort_plan, sort_dispatch
    q, g = _card_quant(e, d, f, dtype, t + 1)
    x = torch.randn((t, d), generator=g, device="cuda")
    idx = torch.randint(0, e - 1, (t, k), generator=g, device="cuda").int()
    plan = make_sort_plan(idx, e, bm)
    te, tv = plan.tile_expert, plan.tile_valid
    counted_rows_on_card(
        "moe_gmm_quant",
        lambda xs: moe_gmm_quant(xs, *q, te, tv, dtype=dtype, block_m=bm),
        lambda xs: moe_gmm_quant_plain(xs, *q, te, tv, bm, dtype=dtype),
        sort_dispatch(x, plan, k), plan, g)


@pytest.mark.parametrize("h,r,dr", [(4, 32, 16), (16, 512, 64),
                                    (40, 256, 32)])
def test_mla_f32_on_card(card, h, r, dr):
    """f32 latents at each (r, dr): against the plain version, the idle
    row zero, and each row alone at its own live width bitwise the batch's
    at the full table."""
    from repro_torch.kernels import flash_decode_paged_mla
    from repro_torch.kernels.flash_decode_paged import \
        flash_decode_paged_mla_plain
    rng = np.random.default_rng(r)
    lens = [512, 300, 129, 17, 0]
    ckvp, kropep, posp, table = latent_pool(rng, lens, page_size=16,
                                             n_blk=40, r=r, dr=dr)
    dev = torch.device("cuda")
    q_lat, q_rope = (torch.from_numpy(rng.normal(size=(len(lens), h, w))
                                      .astype(np.float32)).to(dev)
                     for w in (r, dr))
    ckvp, kropep, posp, table = (torch.from_numpy(a).to(dev) for a in
                                 (ckvp, kropep, posp, table))
    cur = torch.tensor([ln - 1 for ln in lens], dtype=I32, device=dev)
    scale = 0.07
    view = table[:, :32]
    got = flash_decode_paged_mla(q_lat, q_rope, ckvp, kropep, posp, view,
                                 cur, scale=scale)
    _f32_close("flash_decode_paged_mla", got,
               flash_decode_paged_mla_plain(q_lat, q_rope, ckvp, kropep,
                                            posp, view, cur, scale=scale))
    assert (got[-1] == 0).all()
    full = flash_decode_paged_mla(q_lat, q_rope, ckvp, kropep, posp, table,
                                  cur, scale=scale)
    for i, ln in enumerate(lens):
        w = max(1, -(-ln // 16))
        alone = flash_decode_paged_mla(
            q_lat[i:i + 1], q_rope[i:i + 1], ckvp, kropep, posp,
            table[i:i + 1, :w], cur[i:i + 1], scale=scale)
        assert torch.equal(alone[0], full[i]), i


def _card_mla(rng, lens, h, r, dr, n_blk=40):
    """f32 latent pool, q and cur_pos for ``lens`` on the card."""
    ckvp, kropep, posp, table = latent_pool(rng, lens, page_size=16,
                                             n_blk=n_blk, r=r, dr=dr)
    dev = torch.device("cuda")
    q_lat, q_rope = (torch.from_numpy(rng.normal(size=(len(lens), h, w))
                                      .astype(np.float32)).to(dev)
                     for w in (r, dr))
    cur = torch.tensor([ln - 1 for ln in lens], dtype=I32, device=dev)
    return [q_lat, q_rope, *(torch.from_numpy(a).to(dev) for a in
                             (ckvp, kropep, posp, table)), cur]


@pytest.mark.parametrize("h,r,dr,h0,nh", [(16, 512, 64, 0, 8),
                                          (40, 256, 32, 16, 16),
                                          (12, 32, 16, 4, 4)])
def test_mla_f32_head_tiles_on_card(card, h, r, dr, h0, nh):
    """Heads [h0, h0 + nh) of an h-head call are bitwise a call on those
    heads alone: a head's output depends neither on its head tile nor on
    the other heads (DeepSeek's first 8 of 16, MiniCPM3's 16-31 of 40,
    the reduced width's 4-7 of 12)."""
    from repro_torch.kernels import flash_decode_paged_mla
    rng = np.random.default_rng(h + r)
    q_lat, q_rope, *rest = _card_mla(rng, [512, 300, 129, 17, 0], h, r, dr)
    whole = flash_decode_paged_mla(q_lat, q_rope, *rest, scale=0.07)
    alone = flash_decode_paged_mla(
        q_lat[:, h0:h0 + nh].contiguous(), q_rope[:, h0:h0 + nh].contiguous(),
        *rest, scale=0.07)
    assert torch.equal(alone, whole[:, h0:h0 + nh])


@pytest.mark.parametrize("h,r,dr", [(4, 32, 16), (16, 512, 64),
                                    (40, 256, 32)])
def test_mla_f32_trash_and_uneven_walks_on_card(card, h, r, dr):
    """One batch: a row whose table has trash pages between its live ones
    (and past them), and rows whose ranks walk 4 tiles (32 pages), 0 or 1
    (one page) and 1 or 2 (9 pages); against the plain version, and each
    row alone at its own width bitwise the batch's at the full table."""
    from repro_torch.kernels import flash_decode_paged_mla
    from repro_torch.kernels.flash_decode_paged import \
        flash_decode_paged_mla_plain
    rng = np.random.default_rng(r + 1)
    lens = [512, 16, 129, 0, 0]
    q_lat, q_rope, ckvp, kropep, posp, table, cur = _card_mla(
        rng, lens, h, r, dr)
    # the idle row 3 gets 10 live pages spread over 34 columns, trash
    # between and past them, positions in column order
    cols = [0, 2, 3, 7, 8, 9, 15, 24, 31, 33]
    free = int(table.max()) + 1
    for j, col in enumerate(cols):
        table[3, col] = free + j
        posp[free + j] = torch.arange(16 * j, 16 * j + 16, dtype=I32)
    cur[3] = 16 * len(cols) - 3
    got = flash_decode_paged_mla(q_lat, q_rope, ckvp, kropep, posp, table,
                                 cur, scale=0.05)
    _f32_close("flash_decode_paged_mla", got,
               flash_decode_paged_mla_plain(q_lat, q_rope, ckvp, kropep,
                                            posp, table, cur, scale=0.05))
    assert (got[4] == 0).all()
    widths = [32, 1, 9, 34, 1]
    for i, w in enumerate(widths):
        alone = flash_decode_paged_mla(
            q_lat[i:i + 1], q_rope[i:i + 1], ckvp, kropep, posp,
            table[i:i + 1, :w], cur[i:i + 1], scale=0.05)
        assert torch.equal(alone[0], got[i]), i
