"""Parity of the PyTorch port's MLA attention and DeepSeek-V2-Lite with the
JAX reference.

* The plain version of the ``flash_decode_paged_mla`` kernel against the
  Pallas kernel in interpret mode and against the reference's gather-form
  oracle, on latent pools the way the engine leaves them: ragged lengths
  crossing pages, trash page 0 in unmapped table entries, an idle row
  (``cur_pos`` -1, no pages) and a truncated table view; and at the edges
  of the kernel's split of a row over a cluster's ranks (a row whose
  columns wrap past the rank stride, trash columns inside a row).
* ``mla_attention`` against the reference function in train mode, prefill
  into the contiguous cache, chunk on the paged pool, decode on the paged
  pool (the kernel path and the gather path) and decode on the contiguous
  cache, absorbed and materialized, with ``q_lora_rank`` 64 and 0; the
  latents each side writes must agree too.
* The whole reduced DeepSeek-V2-Lite (3 layers: a dense-MLP layer, then two
  MoE layers with shared experts): ``loss_fn`` and the logits, and the
  chunk-prefill and decode logits on the paged pool, on the reference's
  weights converted (``convert.py``).
* Greedy serving tokens against the reference ``Engine``: paged with the
  kernel paths on, a LExI plan over the two MoE layers, and the contiguous
  layout with whole-prompt prefill.
* ``launch/forward.py`` on the reduced model (4 layers): the plan and the
  mean top-k count the MoE layers only.

Tolerance: f32, ``rtol=atol=1e-5`` for the kernel (the same sums in
another order), ``1e-4`` through attention and the model (products summed
in another order at every layer).  The card-only tests hold the CUDA
kernel against its plain version in bf16, and a row's output bitwise alone
and in a batch at a wider table view.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402


KTOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


def latent_pool(rng, lens, *, page_size, n_blk, r, dr):
    """Latent pages as the engine leaves them: row b holds positions
    0..lens[b]-1 in its first pages; unmapped entries point at trash page 0
    (latents zero, posp -1)."""
    b = len(lens)
    n = 1 + b * n_blk
    ckvp = rng.normal(size=(n, page_size, r)).astype(np.float32)
    kropep = rng.normal(size=(n, page_size, dr)).astype(np.float32)
    ckvp[0] = 0.0
    kropep[0] = 0.0
    posp = np.full((n, page_size), -1, np.int32)
    table = np.zeros((b, n_blk), np.int32)
    nxt = 1
    for row, ln in enumerate(lens):
        for j in range(-(-ln // page_size)):
            table[row, j] = nxt
            hi = min(page_size, ln - j * page_size)
            posp[nxt, :hi] = np.arange(j * page_size, j * page_size + hi)
            nxt += 1
    return ckvp, kropep, posp, table


@pytest.mark.parametrize("lens,n_blk,live", [
    ([9, 33, 1, 0], 5, 5),                # ragged, half-filled tails, idle
    ([40, 17, 8], 6, 5),                  # truncated live-page view
    ([3, 16], 2, 2),                      # a page exactly full
])
def test_plain_mla_decode_matches_pallas_and_ref(lens, n_blk, live):
    import jax.numpy as jnp
    from repro.kernels.flash_decode_paged import flash_decode_paged_mla_pallas
    from repro.kernels.ref import flash_decode_paged_mla_ref
    from repro_torch.kernels import flash_decode_paged_mla
    rng = np.random.default_rng(sum(lens))
    h, r, dr, p, scale = 4, 32, 16, 8, 0.17
    ckvp, kropep, posp, table = latent_pool(rng, lens, page_size=p,
                                            n_blk=n_blk, r=r, dr=dr)
    q_lat = rng.normal(size=(len(lens), h, r)).astype(np.float32)
    q_rope = rng.normal(size=(len(lens), h, dr)).astype(np.float32)
    cur = np.array([ln - 1 for ln in lens], np.int32)
    bt = table[:, :live]
    jargs = [jnp.asarray(a) for a in (q_lat, q_rope, ckvp, kropep, posp, bt,
                                      cur)]
    want = np.asarray(flash_decode_paged_mla_pallas(*jargs, scale=scale,
                                                    interpret=True))
    ref = np.asarray(flash_decode_paged_mla_ref(*jargs, scale=scale))
    got = flash_decode_paged_mla(
        *map(torch.from_numpy, (q_lat, q_rope, ckvp, kropep, posp)),
        torch.from_numpy(table)[:, :live], torch.from_numpy(cur),
        scale=scale).numpy()
    np.testing.assert_allclose(got, want, **KTOL)
    np.testing.assert_allclose(got, ref, **KTOL)
    assert all((got[i] == 0).all() for i, ln in enumerate(lens) if ln == 0)


# (lens, n_blk, live, holes): the kernel gives rank r of a row's cluster of
# 8 the table columns r, r + 8, ...
MLA_SPLIT_EDGES = {
    # 19 pages: ranks 0-2 take three columns, the rest two
    "wraps_rank_stride": ([150, 20], 20, 20, ()),
    # trash columns inside the rows, one rank with no page at all
    "trash_columns": ([100, 60], 16, 16, ((0, 1), (0, 9), (0, 4), (1, 2))),
    # an idle row between live ones, on a truncated view
    "idle_row": ([70, 0, 9], 12, 10, ()),
}


@pytest.mark.parametrize("case", list(MLA_SPLIT_EDGES))
def test_plain_mla_decode_split_edges_match_pallas(case):
    import jax.numpy as jnp
    from repro.kernels.flash_decode_paged import flash_decode_paged_mla_pallas
    from repro_torch.kernels import flash_decode_paged_mla
    lens, n_blk, live, holes = MLA_SPLIT_EDGES[case]
    rng = np.random.default_rng(len(case))
    h, r, dr, p, scale = 4, 32, 16, 8, 0.17
    ckvp, kropep, posp, table = latent_pool(rng, lens, page_size=p,
                                            n_blk=n_blk, r=r, dr=dr)
    for row, j in holes:
        table[row, j] = 0
    q_lat = rng.normal(size=(len(lens), h, r)).astype(np.float32)
    q_rope = rng.normal(size=(len(lens), h, dr)).astype(np.float32)
    cur = np.array([ln - 1 for ln in lens], np.int32)
    bt = table[:, :live]
    want = np.asarray(flash_decode_paged_mla_pallas(
        *[jnp.asarray(a) for a in (q_lat, q_rope, ckvp, kropep, posp, bt,
                                   cur)], scale=scale, interpret=True))
    got = flash_decode_paged_mla(
        *map(torch.from_numpy, (q_lat, q_rope, ckvp, kropep, posp)),
        torch.from_numpy(table)[:, :live], torch.from_numpy(cur),
        scale=scale).numpy()
    np.testing.assert_allclose(got, want, **KTOL)
    assert all((got[i] == 0).all() for i, ln in enumerate(lens) if ln == 0)


def _cfgs(q_lora_rank=64, num_layers=3):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    kw = dict(moe_impl="gmm", num_layers=num_layers, q_lora_rank=q_lora_rank)
    return (jget("deepseek-v2-lite").reduced().with_(**kw),
            tget("deepseek-v2-lite").reduced().with_(**kw))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _np(cache):
    return {k: np.asarray(v) for k, v in cache.items()}


# (mode, absorb): absorb does not enter train / prefill; the paged kernel
# path runs only absorbed
MLA_CASES = [("train", True), ("prefill", True), ("chunk", True),
             ("chunk", False), ("decode_paged_kernel", True),
             ("decode_paged", True), ("decode_paged", False),
             ("decode_contiguous", True), ("decode_contiguous", False)]


@pytest.mark.parametrize("q_lora_rank", [64, 0])
@pytest.mark.parametrize("mode,absorb", MLA_CASES)
def test_mla_attention_matches_reference(mode, absorb, q_lora_rank):
    import jax
    import jax.numpy as jnp
    from repro.models import attention as ja
    from repro_torch.models import attention as ta
    cfg_j, cfg_t = _cfgs(q_lora_rank)
    pj = ja.init_attention(jax.random.PRNGKey(3), cfg_j)
    pt = _to_torch(pj)
    assert ("wq_a" in pt) == bool(q_lora_rank)
    rng = np.random.default_rng(11)
    b, c, p, n_blk = 2, 8, 8, 3
    d = cfg_j.d_model
    x = rng.normal(size=(b, c, d)).astype(np.float32)
    pos = np.arange(c)[None].repeat(b, 0).astype(np.int32)

    def both(xx, pp, cj, ct, **kw):
        oj, cj = ja.mla_attention(pj, cfg_j, jnp.asarray(xx), jnp.asarray(pp),
                                  cache=cj, absorb=absorb, **kw)
        kw = {k: (torch.from_numpy(np.asarray(v)) if k == "block_tables"
                  else v) for k, v in kw.items()}
        ot, ct = ta.mla_attention(pt, cfg_t, torch.from_numpy(xx),
                                  torch.from_numpy(pp), cache=ct,
                                  absorb=absorb, **kw)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), **TOL)
        return cj, ct

    if mode == "train":
        both(x, pos, None, None, mode="train")
        return
    if mode in ("prefill", "decode_contiguous"):
        cj = ja.init_cache(cfg_j, b, 32)
        ct = ta.init_cache(cfg_t, b, 32, "cpu")
        cj, ct = both(x, pos, cj, ct, mode="prefill")
        if mode == "decode_contiguous":
            x1 = rng.normal(size=(b, 1, d)).astype(np.float32)
            cj, ct = both(x1, np.array([c, c - 3], np.int32), cj, ct,
                          mode="decode")
    else:
        table = np.array([[1, 2, 3], [4, 5, 0]], np.int32)  # row 1: 2 pages
        cj = ja.init_paged_cache(cfg_j, 1 + b * n_blk, p)
        ct = ta.init_paged_cache(cfg_t, 1 + b * n_blk, p, "cpu")
        for step in range(2):                               # two chunks
            xs = rng.normal(size=(b, c, d)).astype(np.float32)
            ps = pos + step * c
            if step:
                ps[1, 5:] = -1                              # pad tail
            cj, ct = both(xs, ps, cj, ct, mode="chunk", block_tables=table)
        if mode.startswith("decode"):
            x1 = rng.normal(size=(b, 1, d)).astype(np.float32)
            cj, ct = both(x1, np.array([16, 13], np.int32), cj, ct,
                          mode="decode", block_tables=table,
                          use_paged_kernel=mode == "decode_paged_kernel",
                          kernel_blocks=3)
    cj = _np(cj)
    for k, v in ct.items():
        np.testing.assert_allclose(v.numpy(), cj[k], **TOL)


@pytest.fixture(scope="module")
def model():
    import jax
    from repro import models as jm
    from repro_torch.convert import convert_params
    cfg_j, cfg_t = _cfgs()
    assert [s.kind for s in cfg_t.pattern()] == ["attn_mlp", "attn_moe",
                                                 "attn_moe"]
    assert cfg_t.num_shared_experts == 2 and cfg_t.num_moe_layers == 2
    pj = jax.jit(lambda k: jm.init_params(k, cfg_j))(jax.random.PRNGKey(2))
    pt = convert_params(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, cfg_t, pj, pt


def test_convert_splits_mixed_groups_into_layers(model):
    import jax
    from repro_torch.models import init_params
    cfg_j, cfg_t, pj, pt = model
    assert len(pt["layers"]) == 3
    assert "mlp" in pt["layers"][0] and "moe" not in pt["layers"][0]
    for i in (1, 2):
        assert set(pt["layers"][i]["moe"]) == {"router", "w1", "w2",
                                               "shared"}
    stacked = pj["stack"]["groups"][1]["moe"]["w1"]
    assert np.array_equal(pt["layers"][2]["moe"]["w1"].numpy(),
                          np.asarray(stacked[1]))
    # the port's own init has the converted tree's structure and shapes
    own = init_params(cfg_t, 0, device="cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), own)
    assert shapes == jax.tree_util.tree_map(lambda t: tuple(t.shape), pt)


@pytest.mark.parametrize("q_lora_rank", [64, 0])
def test_loss_and_logits_match_reference(q_lora_rank):
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro.models.transformer import forward as jfwd, lm_logits as jlog
    from repro_torch import models as tm
    from repro_torch.convert import convert_params
    from repro_torch.models.transformer import forward as tfwd, \
        lm_logits as tlog
    cfg_j, cfg_t = _cfgs(q_lora_rank)
    pj = jax.jit(lambda k: jm.init_params(k, cfg_j))(jax.random.PRNGKey(5))
    pt = convert_params(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    rng = np.random.default_rng(4)
    b, s = 2, 24
    batch = {k: rng.integers(0, cfg_j.vocab_size, (b, s)).astype(np.int32)
             for k in ("tokens", "targets")}
    batch["mask"] = (rng.random((b, s)) > 0.2).astype(np.int32)
    lj, mj = jax.jit(lambda p_, b_: jm.loss_fn(p_, cfg_j, b_))(
        pj, {k: jnp.asarray(v) for k, v in batch.items()})
    lt, mt = tm.loss_fn(pt, cfg_t, {k: torch.from_numpy(v)
                                    for k, v in batch.items()},
                        opts=tm.ModelOpts(use_moe_kernel=True))
    np.testing.assert_allclose(lt.item(), float(lj), **TOL)
    np.testing.assert_allclose(mt["aux"].item(), float(mj["aux"]), **TOL)
    pos = np.arange(s)[None].repeat(b, 0).astype(np.int32)
    gj = jax.jit(lambda p_, t_, q_: jlog(
        p_, cfg_j, jfwd(p_, cfg_j, t_, q_)[0]))(
        pj, jnp.asarray(batch["tokens"]), jnp.asarray(pos))
    gt = tlog(pt, cfg_t, tfwd(pt, cfg_t, torch.from_numpy(batch["tokens"]),
                              torch.from_numpy(pos))[0])
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **TOL)


@pytest.mark.parametrize("absorb", [True, False])
def test_chunk_prefill_and_decode_logits_match_reference(model, absorb):
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro_torch import models as tm
    cfg_j, cfg_t, pj, pt = model
    rng = np.random.default_rng(0)
    b, c, p, n = 2, 8, 16, 9
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    cj = jm.init_caches(cfg_j, b, 64, layout="paged", page_size=p,
                        num_pages=n)
    ct = tm.init_caches(cfg_t, layout="paged", page_size=p,
                        num_pages=n, device="cpu")
    kern = tm.ModelOpts(use_moe_kernel=True, use_paged_kernel=True,
                        use_moe_decode_kernel=True, mla_absorb=absorb)
    jopts = jm.ModelOpts(use_paged_kernel=True, use_moe_decode_kernel=True,
                         mla_absorb=absorb)
    jchunk = jax.jit(lambda p_, t, po, c_, li, bt_: jm.chunk_prefill_fn(
        p_, cfg_j, t, po, c_, last_index=li, block_tables=bt_, opts=jopts))
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
    lj, cj = jdecode(pj, jnp.asarray(tok), jnp.asarray(pos), cj,
                     jnp.asarray(bt))
    lt, ct = tm.decode_fn(pt, cfg_t, torch.from_numpy(tok),
                          torch.from_numpy(pos), ct,
                          block_tables=torch.from_numpy(bt), opts=kern,
                          kernel_blocks=2)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    from repro_torch.convert import split_stack
    for li, cache in enumerate(split_stack(
            jax.tree.map(np.asarray, {"groups": cj}), cfg_t)):
        np.testing.assert_allclose(ct[li]["ckvp"].numpy(), cache["ckvp"],
                                   **TOL)


def _requests(mod, n, lo, hi, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=rng.integers(
        0, 256, rng.integers(lo, hi)).astype(np.int32),
        max_new_tokens=max_new) for i in range(n)]


@pytest.mark.parametrize("layout", ["paged", "paged_lexi", "contiguous",
                                    "paged_lexi_int8", "paged_int4"])
def test_greedy_serving_matches_reference(model, layout):
    from repro import serving as js
    from repro.serving import Engine as JEngine
    from repro_torch import serving as ts
    from repro_torch.models import ModelOpts
    from repro_torch.serving import Engine as TEngine
    cfg_j, cfg_t, pj, pt = model
    if layout == "contiguous":
        kw = dict(max_batch=3, max_len=64, cache_layout="contiguous",
                  prefill_chunk=0, use_moe_decode=True)
    else:
        # quantized experts: each engine quantizes the same weights at load
        kw = dict(max_batch=3, max_len=64, prefill_chunk=16, page_size=16,
                  use_kernel=True, use_moe_decode=True,
                  expert_dtype=layout.split("_")[-1]
                  if "int" in layout else "bf16")
    ej = JEngine(cfg_j, pj, **kw)
    et = TEngine(cfg_t, pt, opts=ModelOpts(use_moe_kernel=True),
                 device="cpu", **kw)
    plan = None
    if "lexi" in layout:
        plan = "lexi"
        for eng in (ej, et):                # one k per MoE layer
            eng.add_plan(plan, (1, 2))
    rj = ej.serve(_requests(js, 4, 5, 30, 6), plan=plan)
    rt = et.serve(_requests(ts, 4, 5, 30, 6), plan=plan)
    assert [r.uid for r in rj] == [r.uid for r in rt]
    for a, b in zip(rj, rt):
        assert b.tokens == a.tokens, (a.uid, a.tokens, b.tokens)
    assert et.stats["decode_tokens"] == ej.stats["decode_tokens"]
    if plan:
        assert all(r.served_plan == "lexi" for r in rt)


def test_forward_launcher_runs_deepseek_on_cpu(capsys):
    import json
    from repro_torch.launch.forward import main
    assert main(["--arch", "deepseek-v2-lite", "--reduced", "--device",
                 "cpu", "--batch", "1", "--seq", "16", "--reps", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(rec["plan"]) == 3                  # MoE layers only
    models = rec["models"]
    # the mean k is over the MoE layers: the dense first layer has none
    assert models["baseline"]["mean_top_k"] == 2.0
    assert models["lexi"]["mean_top_k"] == np.mean(rec["plan"])
    assert models["intra_prune_0.25"]["moe_d_ff"] == 48
    assert all(np.isfinite(m["xent"]) for m in models.values())


@pytest.mark.parametrize("heads", [16, 12])
def test_mla_decode_kernel_matches_plain_on_card(heads):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")
    from repro_torch.kernels import flash_decode_paged_mla
    from repro_torch.kernels.flash_decode_paged import \
        flash_decode_paged_mla_plain
    rng = np.random.default_rng(3)
    lens = [40, 7, 0, 64]
    ckvp, kropep, posp, table = latent_pool(rng, lens, page_size=16,
                                            n_blk=5, r=512, dr=64)
    dev = torch.device("cuda")
    f32 = [torch.from_numpy(rng.normal(size=(4, heads, w))
                            .astype(np.float32)).to(dev) for w in (512, 64)]
    args = f32 + [torch.from_numpy(a).to(dev, torch.bfloat16)
                  for a in (ckvp, kropep)] + [
        torch.from_numpy(a).to(dev) for a in (posp, table)]
    args[5] = args[5][:, :4]
    args.append(torch.tensor([ln - 1 for ln in lens], dtype=torch.int32,
                             device=dev))
    got = flash_decode_paged_mla(*args, scale=0.07)
    want = flash_decode_paged_mla_plain(*args, scale=0.07)
    assert torch.isfinite(got).all() and (got[2] == 0).all()
    err = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp(min=1e-30)
    assert err[[0, 1, 3]].max() <= 1e-3


def _mla_card_args(lens, n_blk, heads, seed):
    rng = np.random.default_rng(seed)
    ckvp, kropep, posp, table = latent_pool(rng, lens, page_size=16,
                                            n_blk=n_blk, r=512, dr=64)
    dev = torch.device("cuda")
    f32 = [torch.from_numpy(rng.normal(size=(len(lens), heads, w))
                            .astype(np.float32)).to(dev) for w in (512, 64)]
    return f32 + [torch.from_numpy(a).to(dev, torch.bfloat16)
                  for a in (ckvp, kropep)] + [
        torch.from_numpy(a).to(dev) for a in (posp, table)] + [
        torch.tensor([ln - 1 for ln in lens], dtype=torch.int32, device=dev)]


def test_mla_decode_kernel_one_long_row_on_card():
    """One row of 512 positions over 32 pages (four a rank), full width."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")
    from repro_torch.kernels import flash_decode_paged_mla
    from repro_torch.kernels.flash_decode_paged import \
        flash_decode_paged_mla_plain
    args = _mla_card_args([512], 32, 16, seed=4)
    got = flash_decode_paged_mla(*args, scale=0.07)
    want = flash_decode_paged_mla_plain(*args, scale=0.07)
    assert torch.isfinite(got).all()
    err = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp(min=1e-30)
    assert err.max() <= 1e-3


def test_mla_decode_kernel_rows_are_batch_invariant_on_card():
    """Each row alone at its own live-page width gives the bits it gives in
    the batch at a 64-column table view."""
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU")
    from repro_torch.kernels import flash_decode_paged_mla
    lens = [512, 511, 480, 300, 129, 64, 16, 0]
    q_lat, q_rope, ckvp, kropep, posp, table, cur = _mla_card_args(
        lens, 64, 16, seed=8)
    batch = flash_decode_paged_mla(q_lat, q_rope, ckvp, kropep, posp, table,
                                   cur, scale=0.07)
    for r, ln in enumerate(lens):
        live = 1 << (max(1, -(-ln // 16)) - 1).bit_length()  # live_blocks
        alone = flash_decode_paged_mla(
            q_lat[r:r + 1], q_rope[r:r + 1], ckvp, kropep, posp,
            table[r:r + 1, :live], cur[r:r + 1], scale=0.07)
        assert torch.equal(alone[0], batch[r]), r
