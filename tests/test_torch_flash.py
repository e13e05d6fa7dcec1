"""Parity of the port's whole-sequence attention and contiguous-cache decode
with the JAX reference.

* The plain version of the ``flash_attention`` kernel against
  ``flash_attention_pallas`` in interpret mode, over {MHA, GQA g=4} x
  {no window, window 16} x {S 64, ragged S 37}.
* The plain version of the ``flash_decode`` kernel against
  ``flash_decode_pallas`` in interpret mode on caches the way the engine
  leaves them (empty ``pos = -1`` tails, a sliding-window ring that has
  wrapped, an idle row; rows at the edges of the kernel's 32-slot chunks,
  window spans across a chunk boundary), compared on live rows: a row
  with no valid slot gets zeros in the port and the mean of V in the
  reference, and is never read.  The kernel's split: every slot in one
  chunk, and every valid slot inside the chunks its row walks, a count
  that follows from cur_pos and S alone.
* ``gqa_attention`` in ``"prefill"`` mode (through ``flash_attention``) and
  ``"decode"`` mode over the contiguous cache (through ``flash_decode``)
  against the reference function; the cache each side writes must be
  identical too.

Tolerance: f32, ``rtol=atol=2e-5`` (same math, another summation order).
The card-only tests hold each CUDA kernel against its plain version in
bf16, row by row: each output row (one query head's hd values) within
1e-2 of its own norm (f32 sums in another order, bf16 probabilities in
the P V product, bf16 output).  A row over n keys has norm ~ 1/sqrt(n) of
one over a single key, so a bound on the largest output would miss a
long row that sees one key too many or too few.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402


TOL = dict(rtol=2e-5, atol=2e-5)
ROW_TOL = 1e-2


def _qkv(rng, b, hq, hkv, s, hd):
    return (rng.normal(size=(b, hq, s, hd)).astype(np.float32),
            rng.normal(size=(b, hkv, s, hd)).astype(np.float32),
            rng.normal(size=(b, hkv, s, hd)).astype(np.float32))


@pytest.mark.parametrize("s", [64, 37])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 1)])
def test_plain_flash_attention_matches_pallas(hq, hkv, window, s):
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro_torch.kernels import flash_attention
    q, k, v = _qkv(np.random.default_rng(s + hkv), 2, hq, hkv, s, 64)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=window,
                                  interpret=True)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def build_cache(rng, lens, *, s_buf, hkv, hd):
    """Rows written as the engine would: row b holds positions
    0..lens[b]-1 at ring slot pos % s_buf, later writes win."""
    b = len(lens)
    k = rng.normal(size=(b, s_buf, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s_buf, hkv, hd)).astype(np.float32)
    pos = np.full((b, s_buf), -1, np.int32)
    for r, ln in enumerate(lens):
        for p in range(ln):
            pos[r, p % s_buf] = p
    return k, v, pos


@pytest.mark.parametrize("lens,window,hq,hkv", [
    ([9, 48, 1, 0], None, 4, 4),          # half-filled, full, idle row
    ([70, 5, 40, 0], 24, 8, 2),           # ring wrap, window < ring, g=4
])
def test_plain_flash_decode_matches_pallas_on_live_rows(lens, window, hq,
                                                        hkv):
    import jax.numpy as jnp
    from repro.kernels.flash_decode import flash_decode_pallas
    from repro_torch.kernels import flash_decode
    rng = np.random.default_rng(len(lens) + hq)
    hd, s_buf = 32, (48 if window is None else 32)
    k, v, pos = build_cache(rng, lens, s_buf=s_buf, hkv=hkv, hd=hd)
    q = rng.normal(size=(len(lens), hq, hd)).astype(np.float32)
    cur = np.array([ln - 1 for ln in lens], np.int32)
    want = np.asarray(flash_decode_pallas(
        *map(jnp.asarray, (q, k, v, pos, cur)), window=window,
        interpret=True))
    got = flash_decode(*map(torch.from_numpy, (q, k, v, pos, cur)),
                       window=window).numpy()
    live = cur >= 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
    assert (got[~live] == 0).all()


#: lens, cache slots, window, query heads, kv heads: rows ending at the
#: edges of the kernel's 32-slot chunks (and an idle row); windows whose
#: valid span crosses a chunk boundary, inside the ring and wrapped
CHUNK_EDGES = {
    "chunk_edges": ([1, 31, 32, 33, 64, 65, 512, 0], 512, None, 4, 2),
    "window_across_chunk": ([100, 90, 40, 0], 64, 20, 8, 2),
    "wrapped_window_across_chunk": ([130, 64, 33, 0], 64, 48, 4, 4),
}


@pytest.mark.parametrize("case", list(CHUNK_EDGES))
def test_plain_flash_decode_chunk_edges_match_pallas(case):
    import jax.numpy as jnp
    from repro.kernels.flash_decode import flash_decode_pallas
    from repro_torch.kernels import flash_decode
    lens, s_buf, window, hq, hkv = CHUNK_EDGES[case]
    rng = np.random.default_rng(len(case))
    hd = 32
    k, v, pos = build_cache(rng, lens, s_buf=s_buf, hkv=hkv, hd=hd)
    q = rng.normal(size=(len(lens), hq, hd)).astype(np.float32)
    cur = np.array([ln - 1 for ln in lens], np.int32)
    want = np.asarray(flash_decode_pallas(
        *map(jnp.asarray, (q, k, v, pos, cur)), window=window,
        interpret=True))
    got = flash_decode(*map(torch.from_numpy, (q, k, v, pos, cur)),
                       window=window).numpy()
    live = cur >= 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
    assert (got[~live] == 0).all()


def _row_chunks(cur: int, s: int, window) -> int:
    """The chunks a row walks, by the kernel's rule: n slots (none when
    cur < 0, all S under a window, else min(S, cur + 1)), then
    max(1, ceil(n / CHUNK_SLOTS))."""
    from repro_torch.kernels.flash_decode import CHUNK_SLOTS
    n = 0 if cur < 0 else s if window is not None else min(s, cur + 1)
    return max(1, -(-n // CHUNK_SLOTS))


@pytest.mark.parametrize("s", [1, 31, 32, 33, 512])
def test_flash_decode_chunks_cover_every_slot_by_cur_pos_and_s(s):
    """The kernel's chunks: slot j lies in chunk j // CHUNK_SLOTS, the grid's
    chunks cover every slot and none past them, the wrapper's constant is
    the kernel source's, and a row's walked chunks -- a count from its
    cur_pos and S alone -- hold every slot the engine can leave valid."""
    import importlib
    import pathlib
    import re
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    src = (pathlib.Path(fd.__file__).parents[1] / "csrc"
           / "flash_decode.cu").read_text()
    assert int(re.search(r"#define CHUNK_SLOTS (\d+)", src).group(1)) \
        == fd.CHUNK_SLOTS
    nc = fd.n_chunks(s)
    assert {j // fd.CHUNK_SLOTS for j in range(s)} == set(range(nc))
    for window in (None, 5):
        for ln in range(0, 2 * s + 2):
            cur = ln - 1
            walked = _row_chunks(cur, s, window)
            assert 1 <= walked <= nc
            # the engine's layout: position p at slot p % S, later wins
            slot_pos = np.full(s, -1)
            for p in range(ln):
                slot_pos[p % s] = p
            ok = (slot_pos >= 0) & (slot_pos <= cur)
            if window is not None:
                ok &= slot_pos > cur - window
            assert all(j // fd.CHUNK_SLOTS < walked
                       for j in np.flatnonzero(ok))


# --------------------------------------------------------------------------- #
# gqa_attention over the contiguous cache
# --------------------------------------------------------------------------- #


def _attn_setup(window=None, hkv=2):
    import jax
    from repro.configs import get_config as jget
    from repro.models.attention import init_attention
    from repro_torch.configs import get_config as tget
    kw = dict(moe_impl="gmm", sliding_window=window, num_kv_heads=hkv)
    cfg_j = jget("olmoe-1b-7b").reduced().with_(**kw)
    cfg_t = tget("olmoe-1b-7b").reduced().with_(**kw)
    pj = init_attention(jax.random.PRNGKey(6), cfg_j)
    pt = {k: (torch.from_numpy(np.array(v)) if not isinstance(v, dict) else
              {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()})
          for k, v in pj.items()}
    return cfg_j, cfg_t, pj, pt


@pytest.mark.parametrize("window", [None, 12])
def test_gqa_prefill_and_contiguous_decode_match_reference(window):
    import jax.numpy as jnp
    from repro.models.attention import gqa_attention as jattn, \
        init_cache as jcache
    from repro_torch.models.attention import gqa_attention as tattn, \
        init_cache as tcache
    cfg_j, cfg_t, pj, pt = _attn_setup(window)
    rng = np.random.default_rng(11)
    b, s, max_len = 2, 20, 32
    cj = jcache(cfg_j, b, max_len)
    ct = tcache(cfg_t, b, max_len, "cpu")
    x = rng.normal(size=(b, s, cfg_j.d_model)).astype(np.float32)
    pos = np.arange(s)[None].repeat(b, 0).astype(np.int32)
    oj, cj = jattn(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                   mode="prefill", cache=cj, use_flash=True)
    ot, ct = tattn(pt, cfg_t, torch.from_numpy(x), torch.from_numpy(pos),
                   mode="prefill", cache=ct, use_flash=True)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                   **TOL)
    for step in range(2):
        x = rng.normal(size=(b, 1, cfg_j.d_model)).astype(np.float32)
        pos = np.array([s + step, -1 if step else s], np.int32)  # idle row
        for flash in (False, True):
            cj2 = dict(cj)
            ct2 = {k: v.clone() for k, v in ct.items()}
            oj, cj2 = jattn(pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
                            mode="decode", cache=cj2, use_flash_decode=flash)
            ot, ct2 = tattn(pt, cfg_t, torch.from_numpy(x),
                            torch.from_numpy(pos), mode="decode", cache=ct2,
                            use_flash_decode=flash)
            live = pos >= 0
            np.testing.assert_allclose(ot.numpy()[live],
                                       np.asarray(oj)[live], **TOL)
            for name in ("k", "v", "pos"):
                np.testing.assert_allclose(ct2[name].numpy(),
                                           np.asarray(cj2[name]), **TOL)
        cj, ct = cj2, ct2


def test_contiguous_writes_drop_negative_positions():
    from repro_torch.models.attention import _write_seq, _write_step
    buf = torch.zeros(2, 4, dtype=torch.int32)
    # row 0: a pad at slot 0's position and a valid write to slot 0;
    # row 1: nothing valid
    _write_seq(buf, torch.tensor([[7, 8, 9], [5, 5, 5]], dtype=torch.int32),
               torch.tensor([[-1, 4, 1], [-1, -1, -1]]))
    assert buf.tolist() == [[8, 9, 0, 0], [0, 0, 0, 0]]
    _write_step(buf, torch.tensor([3, 6], dtype=torch.int32),
                torch.tensor([-1, 2]))
    assert buf.tolist() == [[8, 9, 0, 0], [0, 0, 6, 0]]


# --------------------------------------------------------------------------- #
# on the card: each kernel against its plain version
# --------------------------------------------------------------------------- #

@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present, decided when the
    test runs (never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")


def _close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).norm(dim=-1)
    ref = want.norm(dim=-1)
    assert (err <= ROW_TOL * ref).all(), (err / ref).max().item()


@pytest.mark.parametrize("b,hq,hkv,s,hd,window", [
    (2, 4, 4, 64, 128, None),
    (1, 16, 16, 200, 128, None),          # ragged last tile
    (1, 8, 2, 37, 64, 16),                # GQA g=4, window, one ragged tile
    (2, 16, 4, 130, 128, 50),             # GQA g=4, window across tiles
    (4, 16, 16, 512, 128, None),          # the Fig. 4 forward's shape
    (4, 16, 16, 512, 64, None),           # the same at hd 64
])
def test_flash_attention_kernel_matches_plain_on_card(card, b, hq, hkv, s,
                                                      hd, window):
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain
    q, k, v = (torch.from_numpy(a).cuda().bfloat16() for a in
               _qkv(np.random.default_rng(s), b, hq, hkv, s, hd))
    before = flash_attention.launches
    _close(flash_attention(q, k, v, window=window),
           flash_attention_plain(q, k, v, window=window))
    assert flash_attention.launches == before + 1


def test_flash_attention_kernel_reads_strided_views_on_card(card):
    """The model passes [B, S, H, hd] activations as transposed views; the
    output comes back in q's layout."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain
    q, k, v = (torch.from_numpy(a).cuda().bfloat16().transpose(1, 2)
               .contiguous().transpose(1, 2) for a in
               _qkv(np.random.default_rng(3), 2, 16, 4, 130, 128))
    got = flash_attention(q, k, v, window=50)
    assert got.stride() == q.stride()
    _close(got, flash_attention_plain(q, k, v, window=50))


@pytest.mark.parametrize("lens,window,hq,hkv,s_buf", [
    ([40, 7, 0, 64], None, 8, 8, 64),
    ([300, 31, 0, 129], 80, 16, 4, 100),      # wrapped ring, g=4
    # rows at the edges of the 32-slot chunks; windows across a boundary
    ([1, 31, 0, 32, 33, 64, 65, 512], None, 16, 16, 512),
    ([100, 90, 0, 40, 130], 20, 16, 4, 64),
    ([130, 64, 0, 33], 48, 8, 8, 64),
])
def test_flash_decode_kernel_matches_plain_on_card(card, lens, window, hq,
                                                   hkv, s_buf):
    from repro_torch.kernels import flash_decode
    from repro_torch.kernels.flash_decode import flash_decode_plain
    rng = np.random.default_rng(5)
    k, v, pos = build_cache(rng, lens, s_buf=s_buf, hkv=hkv, hd=128)
    q = rng.normal(size=(len(lens), hq, 128)).astype(np.float32)
    args = [torch.from_numpy(a).cuda().bfloat16() for a in (q, k, v)]
    args += [torch.from_numpy(pos).cuda(),
             torch.tensor([ln - 1 for ln in lens], dtype=torch.int32,
                          device="cuda")]
    got = flash_decode(*args, window=window)
    want = flash_decode_plain(*args, window=window)
    _close(got, want)
    assert (got[2] == 0).all()                  # the idle row


@pytest.mark.parametrize("hq,hkv,window,lens,s_buf", [
    (16, 16, None, [512, 511, 480, 300, 129, 64, 16, 0], 512),
    (16, 4, 150, [700, 333, 200, 199, 57, 1, 0, 450], 200),
])
def test_flash_decode_kernel_rows_are_batch_invariant_on_card(
        card, hq, hkv, window, lens, s_buf):
    """Each row alone gives the bits it gives in the batch."""
    from repro_torch.kernels import flash_decode
    rng = np.random.default_rng(9)
    k, v, pos = build_cache(rng, lens, s_buf=s_buf, hkv=hkv, hd=128)
    q = rng.normal(size=(len(lens), hq, 128)).astype(np.float32)
    args = [torch.from_numpy(a).cuda().bfloat16() for a in (q, k, v)]
    args += [torch.from_numpy(pos).cuda(),
             torch.tensor([ln - 1 for ln in lens], dtype=torch.int32,
                          device="cuda")]
    batch = flash_decode(*args, window=window)
    for r in range(len(lens)):
        alone = flash_decode(*(a[r:r + 1] for a in args), window=window)
        assert torch.equal(alone[0], batch[r]), r
