"""Parity of the PyTorch port's paged GQA attention with the JAX reference.

* The plain version of the ``flash_decode_paged`` kernel against the Pallas
  kernel in interpret mode, on pools the way the engine leaves them: trash
  page 0 in unmapped table entries, ``posp = -1`` tails, a sliding window
  (ring wrap-around) and a truncated table view.
* ``gqa_attention`` in ``"chunk"``, ``"decode"`` (gather path and paged
  kernel path) and ``"train"`` modes against the reference function, on the
  same paged pool; the pool each side writes must be identical too.

* The edges the kernel's split of a row into chunks of table columns
  creates (a row straddling chunk boundaries, a chunk of trash columns
  only, a window that empties the early chunks, G 8, an idle row), plain
  against Pallas; the chunks cover every column the same way at any
  table width.

Tolerance: f32, ``rtol=atol=1e-5`` (same math, another summation order).
The card-only tests hold the CUDA kernel against its plain version, and a
row's output bitwise alone and in a batch at a wider table view.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402


TOL = dict(rtol=1e-5, atol=1e-5)


def build_pool(rng, lens, *, page_size, n_blk, hkv, hd):
    """Pages written as the engine would: slot b holds positions
    0..lens[b]-1 at ring slot pos % (n_blk * page_size), later writes win;
    unmapped table entries point at trash page 0 (posp -1)."""
    b = len(lens)
    n = 1 + b * n_blk
    kp = rng.normal(size=(n, page_size, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(n, page_size, hkv, hd)).astype(np.float32)
    posp = np.full((n, page_size), -1, np.int32)
    table = np.zeros((b, n_blk), np.int32)
    s_buf = n_blk * page_size
    nxt = 1
    for r, ln in enumerate(lens):
        for j in range(min(-(-ln // page_size), n_blk)):
            table[r, j] = nxt
            nxt += 1
        for pos in range(ln):
            slot = pos % s_buf
            posp[table[r, slot // page_size], slot % page_size] = pos
    return kp, vp, posp, table


@pytest.mark.parametrize("lens,n_blk,live,window,hq,hkv", [
    ([9, 33, 1], 4, 4, None, 4, 2),        # half-filled tails, GQA g=2
    ([70, 5, 40], 4, 4, 24, 4, 4),         # ring wrap under a window
    ([17, 3], 8, 2, None, 2, 1),           # truncated live-page view
])
def test_plain_paged_decode_matches_pallas(lens, n_blk, live, window, hq, hkv):
    import jax.numpy as jnp
    from repro.kernels.flash_decode_paged import flash_decode_paged_pallas
    from repro_torch.kernels import flash_decode_paged
    rng = np.random.default_rng(sum(lens))
    hd, p = 16, 8
    kp, vp, posp, table = build_pool(rng, lens, page_size=p, n_blk=n_blk,
                                     hkv=hkv, hd=hd)
    q = rng.normal(size=(len(lens), hq, hd)).astype(np.float32)
    cur = np.array([ln - 1 for ln in lens], np.int32)
    bt = table[:, :live]
    want = flash_decode_paged_pallas(
        *map(jnp.asarray, (q, kp, vp, posp, bt, cur)), window=window,
        interpret=True)
    got = flash_decode_paged(
        *map(torch.from_numpy, (q, kp, vp, posp)),
        torch.from_numpy(table)[:, :live], torch.from_numpy(cur),
        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _holes(table, holes):
    """Point the given (row, column) entries at trash page 0."""
    table = table.copy()
    for r, j in holes:
        table[r, j] = 0
    return table


# (lens, n_blk, live, window, hq, hkv, holes): chunks are 2 table columns
SPLIT_EDGES = {
    # row 0 spans chunks 0-3 and ends one page past a chunk boundary
    "straddle": ([57, 9, 17], 8, 8, None, 4, 2, ()),
    # chunk 1 of row 0 holds only trash columns, row 1 has a hole too
    "trash_chunk": ([60, 40], 8, 8, None, 2, 2, ((0, 2), (0, 3), (1, 1))),
    # the ring has wrapped and the window leaves only the last pages valid
    "window_empties_early": ([100, 63, 30], 8, 8, 12, 4, 4, ()),
    # G 8 (one kv head for eight query heads) over several chunks
    "g8": ([41, 23], 6, 6, None, 8, 1, ()),
    # an idle row between live ones, on a truncated view
    "idle_row": ([33, 0, 12], 8, 5, None, 4, 2, ()),
}


@pytest.mark.parametrize("case", list(SPLIT_EDGES))
def test_plain_paged_decode_split_edges_match_pallas(case):
    import jax.numpy as jnp
    from repro.kernels.flash_decode_paged import flash_decode_paged_pallas
    from repro_torch.kernels import flash_decode_paged
    lens, n_blk, live, window, hq, hkv, holes = SPLIT_EDGES[case]
    rng = np.random.default_rng(len(case))
    hd, p = 16, 8
    kp, vp, posp, table = build_pool(rng, lens, page_size=p, n_blk=n_blk,
                                     hkv=hkv, hd=hd)
    table = _holes(table, holes)
    q = rng.normal(size=(len(lens), hq, hd)).astype(np.float32)
    cur = np.array([ln - 1 for ln in lens], np.int32)
    bt = table[:, :live]
    want = flash_decode_paged_pallas(
        *map(jnp.asarray, (q, kp, vp, posp, bt, cur)), window=window,
        interpret=True)
    got = flash_decode_paged(
        *map(torch.from_numpy, (q, kp, vp, posp)),
        torch.from_numpy(table)[:, :live], torch.from_numpy(cur),
        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for r, ln in enumerate(lens):
        if ln == 0:
            assert (got[r] == 0).all()


@pytest.mark.parametrize("n_blk", [0, 1, 2, 5, 32, 64])
def test_split_plans_cover_every_column_alike_at_any_width(n_blk):
    """The kernel's chunks: column j lies in chunk j // CHUNK_PAGES whatever
    the table's width, the grid's chunks cover every column and none past
    them, and the wrapper's constant is the kernel source's."""
    import importlib
    import pathlib
    import re
    # the module (the package re-exports the wrapper under its name)
    fdp = importlib.import_module("repro_torch.kernels.flash_decode_paged")
    src = (pathlib.Path(fdp.__file__).parents[1] / "csrc"
           / "flash_decode_paged.cu").read_text()
    assert int(re.search(r"#define CHUNK_PAGES (\d+)", src).group(1)) \
        == fdp.CHUNK_PAGES
    nc = fdp.n_chunks(n_blk)
    chunks = {j // fdp.CHUNK_PAGES for j in range(n_blk)}
    assert nc >= 1 and chunks == set(range(nc if n_blk else 0))
    for wider in (n_blk + 1, n_blk + 64):       # a wider view adds chunks
        assert fdp.n_chunks(wider) >= nc        # at the end only


def test_plain_paged_decode_idle_row_is_zero():
    from repro_torch.kernels import flash_decode_paged
    rng = np.random.default_rng(0)
    kp, vp, posp, table = build_pool(rng, [5, 0], page_size=4, n_blk=2,
                                     hkv=1, hd=8)
    q = torch.from_numpy(rng.normal(size=(2, 1, 8)).astype(np.float32))
    out = flash_decode_paged(q, *map(torch.from_numpy, (kp, vp, posp, table)),
                             torch.tensor([4, -1], dtype=torch.int32))
    assert torch.isfinite(out).all() and (out[1] == 0).all()


def _attn_setup(window=None):
    import jax
    from repro.configs import get_config as jget
    from repro.models.attention import init_attention
    from repro_torch.configs import get_config as tget
    kw = dict(moe_impl="gmm", sliding_window=window, num_kv_heads=2)
    cfg_j = jget("olmoe-1b-7b").reduced().with_(**kw)
    cfg_t = tget("olmoe-1b-7b").reduced().with_(**kw)
    pj = init_attention(jax.random.PRNGKey(4), cfg_j)
    pt = {k: (torch.from_numpy(np.array(v)) if not isinstance(v, dict) else
              {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()})
          for k, v in pj.items()}
    return cfg_j, cfg_t, pj, pt


@pytest.mark.parametrize("window", [None, 20])
def test_gqa_chunk_and_decode_match_reference(window):
    import jax.numpy as jnp
    from repro.models.attention import gqa_attention as jattn, \
        init_paged_cache as jpool
    from repro_torch.models.attention import gqa_attention as tattn, \
        init_paged_cache as tpool
    cfg_j, cfg_t, pj, pt = _attn_setup(window)
    rng = np.random.default_rng(7)
    b, c, p, n_blk = 2, 8, 8, 3
    num_pages = 1 + b * n_blk
    table = np.array([[1, 2, 3], [4, 5, 0]], np.int32)   # row 1: 2 pages
    cj = jpool(cfg_j, num_pages, p)
    ct = tpool(cfg_t, num_pages, p, "cpu")
    for step in range(2):                                # two chunks
        x = rng.normal(size=(b, c, cfg_j.d_model)).astype(np.float32)
        pos = (np.arange(c)[None] + step * c).repeat(b, 0).astype(np.int32)
        pos[1, 6:] = -1                                  # pad tail
        oj, cj = jattn(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                       mode="chunk", cache=cj, block_tables=jnp.asarray(table))
        ot, ct = tattn(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(pos),
                       mode="chunk", cache=ct,
                       block_tables=torch.from_numpy(table))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    np.testing.assert_array_equal(ct["posp"].numpy(), np.asarray(cj["posp"]))
    np.testing.assert_allclose(ct["kp"].numpy(), np.asarray(cj["kp"]), **TOL)
    x = rng.normal(size=(b, 1, cfg_j.d_model)).astype(np.float32)
    pos = np.array([16, 14], np.int32)
    for kernel in (False, True):
        cj2 = dict(cj)
        ct2 = {k: v.clone() for k, v in ct.items()}
        oj, cj2 = jattn(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                        mode="decode", cache=cj2,
                        block_tables=jnp.asarray(table),
                        use_paged_kernel=kernel, kernel_blocks=3)
        ot, ct2 = tattn(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(pos),
                        mode="decode", cache=ct2,
                        block_tables=torch.from_numpy(table),
                        use_paged_kernel=kernel, kernel_blocks=3)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
        np.testing.assert_array_equal(ct2["posp"].numpy(),
                                      np.asarray(cj2["posp"]))


def test_gqa_train_mode_and_negative_positions_write_nothing():
    import jax.numpy as jnp
    from repro.models.attention import gqa_attention as jattn
    from repro_torch.models.attention import _paged_write, gqa_attention
    cfg_j, cfg_t, pj, pt = _attn_setup()
    x = np.random.default_rng(2).normal(size=(2, 10, cfg_j.d_model)).astype(np.float32)
    pos = np.arange(10)[None].repeat(2, 0).astype(np.int32)
    oj, _ = jattn(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos), mode="train")
    ot, _ = gqa_attention(pt, cfg_t, torch.from_numpy(x),
                          torch.from_numpy(pos), mode="train")
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    pages = torch.zeros(3, 4, dtype=torch.int32)
    _paged_write(pages, torch.full((1, 3), 7, dtype=torch.int32),
                 torch.tensor([[-1, 1, -5]]), torch.tensor([[1, 2]]))
    assert pages.sum().item() == 7 and pages[1, 1] == 7


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present, decided when the
    test runs (never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")


@pytest.mark.parametrize("window,live", [(None, 4), (24, 3)])
def test_flash_decode_paged_kernel_matches_plain_on_card(card, window, live):
    from repro_torch.kernels import flash_decode_paged
    from repro_torch.kernels.flash_decode_paged import \
        flash_decode_paged_plain
    rng = np.random.default_rng(3)
    kp, vp, posp, table = build_pool(rng, [40, 7, 0, 64], page_size=16,
                                     n_blk=4, hkv=2, hd=128)
    q = rng.normal(size=(4, 8, 128)).astype(np.float32)
    cur = np.array([39, 6, -1, 63], np.int32)
    args = [torch.from_numpy(a).cuda() for a in (q, kp, vp)]
    args = [a.bfloat16() for a in args] + [
        torch.from_numpy(a).cuda() for a in (posp, table)]
    args[4] = args[4][:, :live]
    args.append(torch.from_numpy(cur).cuda())
    got = flash_decode_paged(*args, window=window).float()
    want = flash_decode_paged_plain(*args, window=window).float()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()


def _card_pool(lens, *, n_blk, hkv, hd, hq, seed, holes=()):
    rng = np.random.default_rng(seed)
    kp, vp, posp, table = build_pool(rng, lens, page_size=16, n_blk=n_blk,
                                     hkv=hkv, hd=hd)
    table = _holes(table, holes)
    q = rng.normal(size=(len(lens), hq, hd)).astype(np.float32)
    dev = torch.device("cuda")
    return ([torch.from_numpy(a).to(dev, torch.bfloat16) for a in (q, kp, vp)]
            + [torch.from_numpy(a).to(dev) for a in (posp, table)]
            + [torch.tensor([ln - 1 for ln in lens], dtype=torch.int32,
                            device=dev)])


def _row_close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).norm(dim=-1)
    ref = want.norm(dim=-1)
    assert (err <= 1e-2 * ref).all(), (err / ref.clamp(min=1e-30)).max()


# (lens, n_blk, hq, hkv, window, holes) at OLMoE's hd 128
CARD_SPLITS = {
    # one row of 512 positions: 32 pages, 16 chunks a kv head
    "one_row_512": ([512], 32, 16, 16, None, ()),
    # live pages ending one page past a chunk boundary, a trash chunk
    "past_boundary_trash_chunk": ([16 * 5, 16 * 9, 3], 16, 16, 16, None,
                                  ((1, 2), (1, 3))),
    # GQA g=4 with a sliding window over pages
    "gqa_window": ([500, 300, 17, 0], 32, 16, 4, 100, ()),
}


@pytest.mark.parametrize("case", list(CARD_SPLITS))
def test_flash_decode_paged_kernel_splits_on_card(card, case):
    from repro_torch.kernels import flash_decode_paged
    from repro_torch.kernels.flash_decode_paged import \
        flash_decode_paged_plain
    lens, n_blk, hq, hkv, window, holes = CARD_SPLITS[case]
    args = _card_pool(lens, n_blk=n_blk, hkv=hkv, hd=128, hq=hq, seed=5,
                      holes=holes)
    got = flash_decode_paged(*args, window=window)
    _row_close(got, flash_decode_paged_plain(*args, window=window))
    for r, ln in enumerate(lens):
        if ln == 0:
            assert (got[r] == 0).all()


@pytest.mark.parametrize("hq,hkv,window", [(16, 16, None), (16, 4, 100)])
def test_flash_decode_paged_kernel_rows_are_batch_invariant_on_card(
        card, hq, hkv, window):
    """Each row alone at its own live-page width gives the bits it gives in
    the batch at a 64-column table view."""
    from repro_torch.kernels import flash_decode_paged
    lens = [512, 511, 480, 300, 129, 64, 16, 0]
    q, kp, vp, posp, table, cur = _card_pool(
        lens, n_blk=64, hkv=hkv, hd=128, hq=hq, seed=9)
    batch = flash_decode_paged(q, kp, vp, posp, table, cur, window=window)
    for r, ln in enumerate(lens):
        live = 1 << (max(1, -(-ln // 16)) - 1).bit_length()  # live_blocks
        alone = flash_decode_paged(q[r:r + 1], kp, vp, posp,
                                   table[r:r + 1, :live], cur[r:r + 1],
                                   window=window)
        assert torch.equal(alone[0], batch[r]), r
