"""The reference kernels' float32 contract on the port: B1 ``moe_gmm``, B2
``flash_attention``, B3 ``moe_decode``, B4 ``flash_decode_paged``, B8
``flash_decode`` and B9 ``moe_ffn`` take f32 operands as their Pallas
references do (which cast to f32 inside and write the input's dtype), and
B2 takes hd 32 in bf16 and in f32.

* On ``meta`` (the card route's checks and costs, no launch): f32 operands
  are taken, the output has the input's dtype, and the launch's cost is
  counted at 4-byte elements; B2 takes hd 32 in both dtypes; a launch
  that mixes bf16 and f32 operands raises.
* The f32 plain versions (the wrappers on CPU tensors) against the
  reference's Pallas kernels in interpret mode, at the reference's own f32
  cases (``tests/test_kernels.py``, ``test_flash_decode.py``,
  ``test_moe_decode.py``, ``test_moe_dispatch.py``,
  ``test_paged_attention.py``), at its f32 tolerance ``rtol=atol=2e-5``.
* Card tests (skipped without a GPU): each f32 kernel against its plain
  version at ``rtol=atol=2e-5`` (B9 at capacities on both sides of its
  decode body's reach, B2 at one row and one past a tile), B9's rows and
  B2's batch rows bit for bit alone, B9's empty rows exactly 0, B1's
  counted rows (``counted_rows_on_card``: a row's bits alone in its tile,
  the rows past a tile's count +0, nonzero padding computed), and B2's
  bf16 body at hd 32 row by row to 1e-2 of each row's norm, as the other
  bf16 attention shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402

#: the reference's f32 tolerance for its kernels (tests/test_kernels.py)
TOL = dict(rtol=2e-5, atol=2e-5)
ROW_TOL = 1e-2
F32 = torch.float32
I32 = torch.int32


# --------------------------------------------------------------------------- #
# meta: f32 operands taken, outputs in the input's dtype, costs at 4 bytes
# --------------------------------------------------------------------------- #


def _cases(dt):
    """name -> (wrapper, args on meta, kwargs, the cost's (flops, bytes) by
    hand at ``dt``'s element size ``es``), at small shapes."""
    from repro_torch import kernels as K
    es = torch.empty((), dtype=dt).element_size()
    b, hq, hkv, s, hd = 2, 4, 2, 8, 32
    e, d, f, k, m, bm = 4, 64, 32, 2, 16, 8
    n, p, nb = 6, 4, 3

    def t(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {
        "flash_attention": (
            K.flash_attention, (t(b, hq, s, hd), t(b, hkv, s, hd),
                                t(b, hkv, s, hd)), {"window": 3},
            # pairs of s = 8 under a window of 3: 1 + 2 + 3 * 6 = 21
            (4 * b * hq * hd * 21,
             es * (2 * b * hq * s * hd + 2 * b * hkv * s * hd))),
        "flash_decode": (
            K.flash_decode, (t(b, hq, hd), t(b, s, hkv, hd), t(b, s, hkv, hd),
                             t(b, s, dtype=I32), t(b, dtype=I32)), {},
            (4 * b * s * hq * hd,
             es * (2 * b * hq * hd + 2 * b * s * hkv * hd) + 4 * b * s
             + 4 * b)),
        "flash_decode_paged": (
            K.flash_decode_paged,
            (t(b, hq, hd), t(n, p, hkv, hd), t(n, p, hkv, hd),
             t(n, p, dtype=I32), t(b, nb, dtype=I32), t(b, dtype=I32)), {},
            (4 * b * nb * p * hq * hd,
             es * 2 * b * hq * hd + b * nb * p * (es * 2 * hkv * hd + 4)
             + 4 * b * nb + 4 * b)),
        "moe_ffn": (
            K.moe_ffn, (t(e, m, d), t(e, d, 2 * f), t(e, f, d)), {},
            (e * m * 6 * d * f, es * (2 * e * m * d + 3 * e * d * f))),
        "moe_gmm": (
            K.moe_gmm, (t(m, d), t(e, d, 2 * f), t(e, f, d),
                        t(m // bm, dtype=I32), t(m // bm, dtype=I32)),
            {"block_m": bm},
            # 2 tiles: at most 2 of the 4 experts
            (m * 6 * d * f, es * (2 * m * d + 2 * 3 * d * f) + 2 * 2 * 4)),
        "moe_decode": (
            K.moe_decode, (t(b, d), t(e, d, 2 * f), t(e, f, d),
                           t(b, k, dtype=I32), t(b, k, dtype=F32)), {},
            # 4 slots: at most the 4 experts
            (b * k * 6 * d * f, es * (2 * b * d + 4 * 3 * d * f)
             + b * k * 8)),
    }


KERNELS = ("flash_attention", "flash_decode", "flash_decode_paged",
           "moe_ffn", "moe_gmm", "moe_decode")


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_meta_route_takes_the_dtype_and_counts_its_bytes(name, dt):
    """f32 (and bf16) operands pass the card route's checks on ``meta``;
    the output has the input's dtype and the reported cost counts each
    float element at its own size (4 bytes in f32).  The shapes run hd
    32, which B2 takes in both dtypes."""
    from repro_torch import kernels as K
    from repro_torch.analysis.counters import count
    wrapper, args, kw, (flops, nbytes) = _cases(dt)[name]
    before = K.launch_counts()
    with count() as c:
        got = wrapper(*args, **kw)
    assert K.launch_counts() == before
    assert got.is_meta and got.dtype == dt
    assert c.kernel_calls == {name: 1}
    assert (c.kernel_flops, c.kernel_bytes) == (flops, nbytes)


@pytest.mark.parametrize("name", KERNELS)
def test_a_dtype_mix_raises(name):
    """Every float operand of a launch shares one dtype: an f32 activation
    with bf16 weights (or the reverse) is refused, never cast."""
    wrapper, args, kw, _ = _cases(torch.float32)[name]
    mixed = list(args)
    mixed[1] = mixed[1].to(torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        wrapper(*mixed, **kw)
    mixed = [a.to(torch.bfloat16) if a.dtype == F32 and i == 0 else a
             for i, a in enumerate(args)]
    with pytest.raises(TypeError, match="float32"):
        wrapper(*mixed, **kw)


def test_f32_decode_attention_stops_at_hd_128():
    """B4 and B8 take f32 at hd 32-128; hd 256 only in bf16 (a tile of f32
    K and V rows there would overflow a block's static shared memory)."""
    from repro_torch import kernels as K

    def t(*shape, dtype=F32):
        return torch.empty(shape, dtype=dtype, device="meta")
    for dt in (torch.bfloat16, F32):
        args = (t(1, 2, 256, dtype=dt), t(1, 8, 2, 256, dtype=dt),
                t(1, 8, 2, 256, dtype=dt), t(1, 8, dtype=I32),
                t(1, dtype=I32))
        if dt == F32:
            with pytest.raises(ValueError, match="no kernel"):
                K.flash_decode(*args)
        else:
            assert K.flash_decode(*args).dtype == dt


# --------------------------------------------------------------------------- #
# the f32 plain versions against the Pallas kernels, the reference's cases
# --------------------------------------------------------------------------- #


def _np(x):
    return np.asarray(x, np.float32)


#: B9's f32 capacities on the card: C 1-24 run its decode body (C 1-4
#: in row groups of 4, else 8), C 25 up its tile body (C 80: one tile of
#: 80 rows, C 320: four); the CPU cases take them at small widths
FFN_CAPACITIES = (1, 16, 17, 24, 25, 80, 320)


@pytest.mark.parametrize("e,c,d,f", [
    (1, 8, 64, 32), (4, 64, 128, 96), (8, 16, 256, 64), (2, 128, 128, 256),
    (3, 20, 96, 48), *((3, c, 128, 64) for c in FFN_CAPACITIES)])
def test_moe_ffn_f32_matches_pallas(e, c, d, f):
    import jax.numpy as jnp
    from repro.kernels.moe_ffn import moe_ffn_pallas
    from repro_torch.kernels import moe_ffn
    rng = np.random.default_rng(e * 100 + c)
    xe = rng.normal(size=(e, c, d)).astype(np.float32)
    w1 = (rng.normal(size=(e, d, 2 * f)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(e, f, d)) * 0.05).astype(np.float32)
    got = moe_ffn(*map(torch.from_numpy, (xe, w1, w2)))
    assert got.dtype == F32
    want = moe_ffn_pallas(*map(jnp.asarray, (xe, w1, w2)), block_c=16,
                          block_f=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


#: B2's f32 edge shapes (b, hq, hkv, s, hd, window): one row, one row
#: past a 64-row tile, one past two, and hd 80 under a window
FA_EDGES = [(2, 4, 2, 1, 32, None), (2, 4, 2, 65, 64, None),
            (1, 4, 2, 129, 32, None), (2, 8, 2, 129, 80, 50)]


@pytest.mark.parametrize("b,hq,hkv,s,hd,window", [
    (1, 1, 1, 64, 32, None), (2, 4, 2, 128, 64, None),
    (1, 8, 1, 256, 64, None), (2, 4, 4, 96, 32, None),
    (2, 2, 2, 128, 32, 16), (2, 2, 2, 128, 32, 64), (2, 2, 2, 128, 32, 100),
    *FA_EDGES])
def test_flash_attention_f32_matches_pallas(b, hq, hkv, s, hd, window):
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro_torch.kernels import flash_attention
    rng = np.random.default_rng(s + hq)
    q = rng.normal(size=(b, hq, s, hd)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, hd)).astype(np.float32)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    assert got.dtype == F32
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)),
                                  window=window, block_q=32, block_k=32,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def _decode_case(b, hq, hkv, s, hd, filled, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    pos = np.full((b, s), -1, np.int32)
    pos[:, :filled] = np.arange(filled)
    cur = np.full((b,), filled - 1, np.int32)
    return q, k, v, pos, cur


@pytest.mark.parametrize("b,hq,hkv,s,hd,filled,window", [
    (1, 4, 1, 64, 32, 40, None), (2, 8, 2, 128, 64, 128, None),
    (2, 4, 4, 96, 32, 17, None), (2, 4, 2, 128, 32, 100, 16),
    (2, 4, 2, 128, 32, 100, 50)])
def test_flash_decode_f32_matches_pallas(b, hq, hkv, s, hd, filled, window):
    import jax.numpy as jnp
    from repro.kernels.flash_decode import flash_decode_pallas
    from repro_torch.kernels import flash_decode
    case = _decode_case(b, hq, hkv, s, hd, filled)
    got = flash_decode(*map(torch.from_numpy, case), window=window)
    assert got.dtype == F32
    want = flash_decode_pallas(*map(jnp.asarray, case), window=window,
                               block_k=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("b,e,k", [(1, 8, 2), (8, 4, 4), (3, 16, 1),
                                   (7, 5, 3)])
def test_moe_decode_f32_matches_pallas(b, e, k):
    import jax.numpy as jnp
    from repro.kernels.moe_decode import moe_decode_pallas
    from repro_torch.kernels import moe_decode
    rng = np.random.default_rng(b * 31 + e + k)
    d, f = 32, 48
    x = rng.normal(size=(b, d)).astype(np.float32)
    w1 = (rng.normal(size=(e, d, 2 * f)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(e, f, d)) * 0.05).astype(np.float32)
    idx = rng.integers(0, e, size=(b, k)).astype(np.int32)
    w = rng.random((b, k)).astype(np.float32)
    case = (x, w1, w2, idx, w)
    got = moe_decode(*map(torch.from_numpy, case))
    assert got.dtype == F32
    want = moe_decode_pallas(*map(jnp.asarray, case), block_f=16,
                             interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


#: (experts, rows an expert, D, F, block_m, real rows set to all zero as
#: (expert, row) pairs, padding rows of the first padded expert set
#: nonzero): the reference's padded layout, and the layouts the f32
#: kernels' row count meets -- tiles of 64 and 128 rows holding a few,
#: an all-zero real row inside a group and at its end, and padding rows
#: a caller left nonzero, which the kernel computes as the reference does
GMM_F32_LAYOUTS = [
    ((4, (8, 0, 16, 8), 64, 32, 8, (), 0), "4-sizes0-64-32-8"),
    ((3, (4, 5, 3), 64, 96, 8, (), 0), "3-sizes1-64-96-8"),
    ((2, (0, 0), 32, 32, 8, (), 0), "2-sizes2-32-32-8"),
    ((5, (40, 0, 8, 1, 15), 128, 64, 16, (), 0), "5-sizes3-128-64-16"),
    ((4, (3, 0, 5, 2), 128, 64, 64, (), 0), "bm64-few-rows"),
    ((3, (2, 7, 1), 128, 64, 128, (), 0), "bm128-few-rows"),
    ((4, (6, 0, 9, 3), 128, 64, 64, ((0, 2), (2, 8)), 0), "bm64-zero-rows"),
    ((3, (5, 2, 7), 128, 64, 128, (), 3), "bm128-nonzero-padding"),
]


def padded_layout(rng, sizes, bm, d, zero=(), pad=0):
    """xs [n_tiles * bm, D] in the reference's padded layout (each
    expert's ``sizes`` rows padded to whole tiles, one dead trailing tile),
    the ``zero`` (expert, row) real rows all zero and ``pad`` padding rows
    of the first expert with any set nonzero; with tile_expert (clamped)
    and tile_valid."""
    sizes = np.asarray(sizes)
    e = len(sizes)
    padded = (sizes + bm - 1) // bm * bm
    n_tiles = int(padded.sum()) // bm + 1
    xs = np.zeros((n_tiles * bm, d), np.float32)
    starts = np.cumsum(padded) - padded
    for ei in range(e):
        xs[starts[ei]:starts[ei] + sizes[ei]] = rng.normal(
            size=(sizes[ei], d))
    for ei, r in zero:
        assert r < sizes[ei]
        xs[starts[ei] + r] = 0.0
    if pad:
        ei = int(np.flatnonzero(padded > sizes)[0])
        assert pad <= padded[ei] - sizes[ei]
        r0 = starts[ei] + sizes[ei]
        xs[r0:r0 + pad] = rng.normal(size=(pad, d))
    row0 = np.arange(n_tiles) * bm
    te = np.searchsorted(np.cumsum(padded), row0, side="right")
    te_c = np.minimum(te, e - 1).astype(np.int32)
    tv = ((te < e) & (row0 - starts[te_c] < sizes[te_c])).astype(np.int32)
    return xs, te_c, tv


@pytest.mark.parametrize("e,sizes,d,f,bm,zero,pad",
                         [c for c, _ in GMM_F32_LAYOUTS],
                         ids=[i for _, i in GMM_F32_LAYOUTS])
def test_moe_gmm_f32_matches_pallas(e, sizes, d, f, bm, zero, pad):
    """The reference's padded tile layout (each expert's rows padded to
    whole tiles, one dead trailing tile), and the f32 row count's edges."""
    import jax.numpy as jnp
    from repro.kernels.moe_gmm import moe_gmm_pallas
    from repro_torch.kernels import moe_gmm
    rng = np.random.default_rng(int(np.sum(sizes)))
    w1 = (rng.normal(size=(e, d, 2 * f)) * 0.05).astype(np.float32)
    w2 = (rng.normal(size=(e, f, d)) * 0.05).astype(np.float32)
    xs, te_c, tv = padded_layout(rng, sizes, bm, d, zero, pad)
    case = (xs, w1, w2, te_c, tv)
    got = moe_gmm(*map(torch.from_numpy, case), block_m=bm)
    assert got.dtype == F32
    want = moe_gmm_pallas(*map(jnp.asarray, case), block_m=bm, block_f=32,
                          interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("sizes,bm,zero,pad", [
    ((8, 0, 16, 8), 8, (), 0), ((40, 0, 8, 1, 15), 16, ((0, 39),), 0),
    ((3, 0, 5, 2), 64, ((2, 0),), 0), ((5, 2, 7), 128, (), 3),
    ((0, 0), 8, (), 0)])
def test_tile_rows_counts_to_each_tiles_last_nonzero_row(sizes, bm, zero,
                                                         pad):
    """``tile_rows``, the plain version of the f32 kernels' count pass: 1 +
    each live tile's last row that is not all zero, 0 for a dead tile."""
    from repro_torch.kernels.moe_gmm import tile_rows
    xs, _, tv = padded_layout(np.random.default_rng(3), sizes, bm, 16,
                              zero, pad)
    want = [0 if not v else max(
        [r + 1 for r in range(bm) if xs[t * bm + r].any()], default=0)
        for t, v in enumerate(tv)]
    got = tile_rows(torch.from_numpy(xs), torch.from_numpy(tv), bm)
    assert got.dtype == I32 and got.tolist() == want


def _paged_case(rng, lens, page_size, n_blk, hkv, hd):
    """A pool written the way the engine writes it: ``lens[b]`` positions
    of row b on its own pages (ring slot = pos % (n_blk * page_size)), the
    trash page 0 and unmapped table entries left at 0."""
    p, s_buf = page_size, n_blk * page_size
    used = [-(-min(n, s_buf) // p) for n in lens]
    n_pages = 1 + sum(used)
    kp, vp = (rng.normal(size=(n_pages, p, hkv, hd)).astype(np.float32)
              for _ in range(2))
    posp = np.full((n_pages, p), -1, np.int32)
    table = np.zeros((len(lens), n_blk), np.int32)
    page = 1
    for bi, n in enumerate(lens):
        for j in range(used[bi]):
            table[bi, j] = page
            for off in range(p):
                slot = j * p + off
                if slot < min(n, s_buf):
                    posp[page, off] = slot + (n - 1 - slot) // s_buf * s_buf
            page += 1
    return kp, vp, posp, table, np.asarray([n - 1 for n in lens], np.int32)


@pytest.mark.parametrize("lens,page_size,n_blk,hkv,g,window", [
    ([5, 12, 1], 4, 4, 2, 2, None),
    ([30, 9], 8, 3, 1, 4, None),
    ([40, 17, 3], 4, 5, 2, 1, 10),      # a window
    ([50, 21], 4, 4, 1, 2, 16)])        # window == buffer: the ring wrapped
def test_flash_decode_paged_f32_matches_pallas(lens, page_size, n_blk, hkv,
                                               g, window):
    import jax.numpy as jnp
    from repro.kernels.flash_decode_paged import flash_decode_paged_pallas
    from repro_torch.kernels import flash_decode_paged
    rng = np.random.default_rng(sum(lens))
    hd = 8
    kp, vp, posp, table, cur = _paged_case(rng, lens, page_size, n_blk, hkv,
                                           hd)
    q = rng.normal(size=(len(lens), hkv * g, hd)).astype(np.float32)
    case = (q, kp, vp, posp, table, cur)
    got = flash_decode_paged(*map(torch.from_numpy, case), window=window)
    assert got.dtype == F32
    want = flash_decode_paged_pallas(*map(jnp.asarray, case), window=window,
                                     interpret=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# --------------------------------------------------------------------------- #
# on the card: each f32 kernel against its plain version
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


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("b,hq,hkv,s,hd,window", [
    (2, 4, 4, 64, 32, None), (1, 8, 2, 200, 32, 50), (2, 4, 2, 130, 64, None),
    (1, 4, 4, 37, 80, None), (2, 16, 16, 512, 128, None),
    (2, 4, 2, 1, 128, None), (2, 4, 2, 65, 64, None), *FA_EDGES[2:]])
def test_flash_attention_f32_on_card(card, b, hq, hkv, s, hd, window):
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain
    g = _gen(s)
    q = torch.randn((b, hq, s, hd), generator=g, device="cuda")
    k, v = (torch.randn((b, hkv, s, hd), generator=g, device="cuda")
            for _ in range(2))
    _f32_close("flash_attention", flash_attention(q, k, v, window=window),
               flash_attention_plain(q, k, v, window=window))
    # the model's [B, S, H, hd] activations as transposed views
    qt, kt, vt = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    got = flash_attention(qt, kt, vt, window=window)
    assert got.stride() == qt.stride()
    _f32_close("flash_attention", got,
               flash_attention_plain(q, k, v, window=window))


@pytest.mark.parametrize("hd,window", [(128, None), (80, 50), (32, 40)])
def test_flash_attention_f32_rows_alone_on_card(card, hd, window):
    """Each batch row of the model's [B, S, H, hd] views alone gives the
    bits it gives in the batch."""
    from repro_torch.kernels import flash_attention
    g = _gen(hd)
    q, k, v = (torch.randn((3, 129, h, hd), generator=g, device="cuda")
               .transpose(1, 2) for h in (8, 2, 2))
    batch = flash_attention(q, k, v, window=window)
    for i in range(3):
        alone = flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                window=window)
        assert torch.equal(alone[0], batch[i])


def test_flash_attention_bf16_hd32_on_card(card):
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain
    g = _gen(7)
    q = torch.randn((2, 4, 130, 32), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((2, 2, 130, 32), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    for window in (None, 40):
        got = flash_attention(q, k, v, window=window).float()
        want = flash_attention_plain(q, k, v, window=window).float()
        err = (got - want).norm(dim=-1) / want.norm(dim=-1)
        assert err.max().item() <= ROW_TOL


@pytest.mark.parametrize("hq,hkv,hd,lens,s_buf,window", [
    (4, 4, 32, [40, 7, 0, 64], 64, None), (8, 2, 64, [300, 33], 512, None),
    (16, 16, 128, [512, 77, 1], 512, None), (8, 2, 80, [190, 40], 200, 150)])
def test_flash_decode_f32_on_card(card, hq, hkv, hd, lens, s_buf, window):
    from repro_torch.kernels import flash_decode
    from repro_torch.kernels.flash_decode import flash_decode_plain
    g = _gen(s_buf)
    b = len(lens)
    q = torch.randn((b, hq, hd), generator=g, device="cuda")
    k, v = (torch.randn((b, s_buf, hkv, hd), generator=g, device="cuda")
            for _ in range(2))
    pos = torch.full((b, s_buf), -1, dtype=I32)
    for i, n in enumerate(lens):        # position p in slot p % s_buf
        for p_ in range(max(0, n - s_buf), n):
            pos[i, p_ % s_buf] = p_
    pos = pos.cuda()
    cur = torch.tensor([n - 1 for n in lens], dtype=I32, device="cuda")
    _f32_close("flash_decode",
               flash_decode(q, k, v, pos, cur, window=window),
               flash_decode_plain(q, k, v, pos, cur, window=window))


@pytest.mark.parametrize("hq,hkv,hd,lens,window", [
    (4, 4, 32, [40, 7, 1, 64], None), (16, 16, 128, [512, 77], None),
    (8, 2, 64, [130, 33, 260], 100)])
def test_flash_decode_paged_f32_on_card(card, hq, hkv, hd, lens, window):
    from repro_torch.kernels import flash_decode_paged
    from repro_torch.kernels.flash_decode_paged import \
        flash_decode_paged_plain
    rng = np.random.default_rng(hd)
    n_blk = max(-(-n // 16) for n in lens)
    kp, vp, posp, table, cur = (torch.from_numpy(a).cuda() for a in
                                _paged_case(rng, lens, 16, n_blk, hkv, hd))
    q = torch.from_numpy(rng.normal(size=(len(lens), hq, hd))
                         .astype(np.float32)).cuda()
    _f32_close("flash_decode_paged",
               flash_decode_paged(q, kp, vp, posp, table, cur, window=window),
               flash_decode_paged_plain(q, kp, vp, posp, table, cur,
                                        window=window))


def _experts(e, d, f, seed):
    """w1, w2 at the model's own init scale, 1 / sqrt(fan in) (the
    reference's cases take 0.05 at d 32-256, about the same): an f32
    sum's rounding grows with its terms, so a scale that blows the
    hidden up at d 2048 holds two summation orders to more than 2e-5."""
    g = _gen(seed)
    return (torch.randn((e, d, 2 * f), generator=g, device="cuda")
            / d ** 0.5,
            torch.randn((e, f, d), generator=g, device="cuda") / f ** 0.5)


@pytest.mark.parametrize("e,c,d,f", [
    (8, 4, 128, 64), (8, 80, 128, 128), (16, 130, 256, 96),
    (4, 4, 2048, 1024), *((4, c, 2048, 1024) for c in FFN_CAPACITIES)])
def test_moe_ffn_f32_on_card(card, e, c, d, f):
    from repro_torch.kernels import moe_ffn
    from repro_torch.kernels.moe_ffn import moe_ffn_plain
    w1, w2 = _experts(e, d, f, c)
    xe = torch.randn((e, c, d), generator=_gen(1), device="cuda")
    xe[:, (c + 1) // 2:] = 0              # empty capacity rows
    _f32_close("moe_ffn", moe_ffn(xe, w1, w2), moe_ffn_plain(xe, w1, w2))


@pytest.mark.parametrize("c", [4, 8, 24, 25])
def test_moe_ffn_f32_wide_on_card(card, c):
    """llama4-scout's expert widths (D 5120, F 8192): the decode body
    stages its rows in chunks there (C 4 in 2 a pass, C 8 and 24 in 3 and
    4), the tile body takes C 25."""
    from repro_torch.kernels import moe_ffn
    from repro_torch.kernels.moe_ffn import moe_ffn_plain
    w1, w2 = _experts(2, 5120, 8192, c)
    xe = torch.randn((2, c, 5120), generator=_gen(6), device="cuda")
    xe[:, (c + 1) // 2:] = 0              # empty capacity rows
    got = moe_ffn(xe, w1, w2)
    _f32_close("moe_ffn", got, moe_ffn_plain(xe, w1, w2))
    assert (got[:, (c + 1) // 2:] == 0).all()


@pytest.mark.parametrize("c", [4, 80])
def test_moe_ffn_f32_rows_alone_on_card(card, c):
    """A capacity row alone (every other row of its buffer zero) gives the
    bits it gives among the others, in both bodies."""
    from repro_torch.kernels import moe_ffn
    w1, w2 = _experts(4, 2048, 1024, c)
    xe = torch.randn((4, c, 2048), generator=_gen(4), device="cuda")
    batch = moe_ffn(xe, w1, w2)
    for r in range(0, c, max(1, c // 8)):
        alone = torch.zeros_like(xe)
        alone[:, r] = xe[:, r]
        assert torch.equal(moe_ffn(alone, w1, w2)[:, r], batch[:, r])


@pytest.mark.parametrize("c", [4, 24, 80])
def test_moe_ffn_f32_empty_rows_are_zero_on_card(card, c):
    """A capacity row that no token copy filled comes out exactly 0."""
    from repro_torch.kernels import moe_ffn
    w1, w2 = _experts(4, 2048, 1024, c)
    xe = torch.randn((4, c, 2048), generator=_gen(5), device="cuda")
    xe[:, 1::2] = 0
    out = moe_ffn(xe, w1, w2)
    assert (out[:, 1::2] == 0).all() and (out[:, ::2] != 0).any()


#: B1 / B6 f32 on the card: a 64-token prefill chunk at top-8 and a top-1
#: dispatch over 16 experts, at OLMoE's D and F, tiles of 128 rows
GMM_F32_CARD = [(64, 8, 64, 128, 2048, 1024), (512, 1, 16, 128, 2048, 1024)]


@pytest.mark.parametrize("t,k,e,bm,d,f", [
    (5, 2, 8, 8, 128, 64), (37, 2, 8, 40, 128, 128),
    (512, 8, 64, 128, 256, 96), (200, 4, 16, 128, 2048, 1024),
    *GMM_F32_CARD])
def test_moe_gmm_f32_on_card(card, t, k, e, bm, d, f):
    from repro_torch.kernels import moe_gmm
    from repro_torch.kernels.moe_gmm import moe_gmm_plain
    from repro_torch.models.moe import make_sort_plan, sort_dispatch
    w1, w2 = _experts(e, d, f, t)
    g = _gen(2)
    x = torch.randn((t, d), generator=g, device="cuda")
    idx = torch.randint(0, e - 1, (t, k), generator=g, device="cuda").int()
    plan = make_sort_plan(idx, e, bm)
    args = (sort_dispatch(x, plan, k), w1, w2, plan.tile_expert,
            plan.tile_valid)
    got = moe_gmm(*args, block_m=bm)
    dead = ~plan.tile_valid.bool()
    assert (got.reshape(-1, bm, d)[dead] == 0).all()
    _f32_close("moe_gmm", got, moe_gmm_plain(*args, bm))


def counted_rows_on_card(name, run, plain, xs, plan, gen):
    """The f32 sorted-buffer kernels compute each tile's rows up to its
    last row that is not all zero: (a) a row of the tile with the most
    real rows gives the same bits alone in it (its tile-mates zero: fewer
    rows counted, another block shape) as among them; (b) with a real row
    of that tile set to zero, that row and every row past each tile's
    count come out exactly +0; (c) padding rows a caller left nonzero are
    computed, as the plain version computes them."""
    from repro_torch.kernels.moe_gmm import tile_rows
    bm, d = plan.block_m, xs.shape[1]
    sizes = plan.group_sizes.long()
    padded = plan.padded_group_sizes.long()
    starts = torch.cumsum(padded, 0) - padded
    ei = int(torch.argmax(sizes))
    r0, n = int(starts[ei]), int(sizes[ei])
    assert n >= 3
    batch = run(xs)
    for r in sorted({0, min(15, n - 1), min(16, n - 1), n - 1}):
        alone = torch.zeros_like(xs)
        alone[r0 + r] = xs[r0 + r]
        assert torch.equal(run(alone)[r0 + r], batch[r0 + r]), r
    xz = xs.clone()
    xz[r0 + n // 2] = 0.0
    out = run(xz).reshape(-1, bm, d)
    rows = tile_rows(xz, plan.tile_valid, bm)
    past = torch.arange(bm, device=xs.device)[None] >= rows[:, None]
    assert int(rows.sum()) < xs.shape[0]
    for zero in (out[past], out.reshape(-1, d)[r0 + n // 2]):
        assert (zero == 0).all() and not torch.signbit(zero).any()
    ep = int(torch.nonzero(padded > sizes)[0])
    p0 = int(starts[ep] + sizes[ep])
    pad = min(5, int(padded[ep] - sizes[ep]))
    xp = xs.clone()
    xp[p0:p0 + pad] = torch.randn((pad, d), generator=gen, device=xs.device)
    got = run(xp)
    assert (got[p0:p0 + pad] != 0).any()
    _f32_close(name, got, plain(xp))


@pytest.mark.parametrize("t,k,e,bm,d,f", [(37, 2, 8, 40, 128, 128),
                                          *GMM_F32_CARD])
def test_moe_gmm_f32_counted_rows_on_card(card, t, k, e, bm, d, f):
    from repro_torch.kernels import moe_gmm
    from repro_torch.kernels.moe_gmm import moe_gmm_plain
    from repro_torch.models.moe import make_sort_plan, sort_dispatch
    w1, w2 = _experts(e, d, f, t)
    g = _gen(7)
    x = torch.randn((t, d), generator=g, device="cuda")
    idx = torch.randint(0, e - 1, (t, k), generator=g, device="cuda").int()
    plan = make_sort_plan(idx, e, bm)
    te, tv = plan.tile_expert, plan.tile_valid
    counted_rows_on_card(
        "moe_gmm", lambda xs: moe_gmm(xs, w1, w2, te, tv, block_m=bm),
        lambda xs: moe_gmm_plain(xs, w1, w2, te, tv, bm),
        sort_dispatch(x, plan, k), plan, g)


@pytest.mark.parametrize("b,k,e,d,f", [(1, 2, 8, 128, 64), (8, 2, 8, 128, 128),
                                       (8, 8, 64, 2048, 1024),
                                       (3, 4, 16, 256, 1056)])
def test_moe_decode_f32_on_card(card, b, k, e, d, f):
    from repro_torch.kernels import moe_decode
    from repro_torch.kernels.moe_decode import moe_decode_plain
    w1, w2 = _experts(e, d, f, b * k)
    g = _gen(3)
    x = torch.randn((b, d), generator=g, device="cuda")
    idx = torch.randint(0, e, (b, k), generator=g, device="cuda").int()
    w = torch.rand((b, k), generator=g, device="cuda")
    _f32_close("moe_decode", moe_decode(x, w1, w2, idx, w),
               moe_decode_plain(x, w1, w2, idx, w))
