"""Tensor parallelism over ``model``: the port in a (1, 4) gloo world of
four processes on the CPU, against the port's one-process paths and the
JAX reference.

One ``torch.multiprocessing.spawn`` for the module (``_torch_tp_ranks.py``
is the rank program; ``file://`` rendezvous, one torch thread a rank);
while it runs, this process computes the one-process references and the
JAX oracles, then every test reads the ranks' results.  The configs
(``_torch_tp_ranks.configs``) cover heads that a column block cuts
through (q and kv) and heads that align, MLA, a mamba stack, a tied
embedding, experts split over ``model`` and experts split by F.

Where the experts split, the MoE runs ``ep_a2a``, whose aux is the mean
over the ``model`` ranks of each rank's own rows' (one batch row a rank):
the one-process loss it equals is the mean of the rows' losses, and the
gradients the one-process step's with one microbatch a row.  The JAX
reference runs its dense MoE, never ``ep_a2a`` / ``ep_psum``, and is held
on the cross-entropy and the logits.

The loss stays vocab-parallel (each rank's block of the logits, three
sums of [B, S] over ``model``; ``models.tp.xent``), and a sum over
``model`` notes its backward's sum (the mamba stacks' gated norm).  At
one rank the vocab-parallel loss is the whole-vocab one bit for bit.

A decode step in ``attn_compute_dtype="bf16_accum32"`` (q f32, a bf16
cache; ``_torch_tp_ranks.attn_decode``) runs under
``decode_kv_seq_shard`` on the ranks' sequence blocks, against the
port's unsharded decode and the reference's, 1e-5 each.

Tolerances: losses and logits 1e-5 against the port (the same products in
other blocks and orders), 2e-4 against JAX; gradients 1e-4 relative to
each leaf's largest entry (sums over four ranks in another order);
greedy engine tokens equal.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402

import _torch_tp_ranks as ranks  # noqa: E402

#: seconds the four ranks may take (about 20 s on an idle host)
SPAWN_TIMEOUT = 300
PORT = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=2e-4, atol=2e-4)
TAGS = list(ranks.configs())
#: the configs whose logits are held against JAX: heads that a column
#: block cuts through, and MLA heads that align
JAX_LOGITS = ("gqa_split", "mla")
#: the configs whose pool splits heads over ``model`` 4: GQA kv heads (4,
#: or zamba2's shared attention) or mamba state heads; ``gqa_split``'s 2
#: kv heads and MLA's latent rows stay whole
SPLIT_POOL = ("gqa_aligned", "fsplit_gmm", "zamba2", "zamba2_whole", "tied")


def _join(ctx, timeout):
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the four ranks ran past {timeout} s")


def _one_process(cfg):
    """The port in this process on the whole params."""
    from repro_torch import models
    from repro_torch.training import value_and_grad
    params = models.init_params(cfg, 0, device="cpu")
    b = ranks.batch(cfg)
    if ranks.experts_split(cfg):
        rows = [models.loss_fn(params, cfg, {k: v[i:i + 1]
                                             for k, v in b.items()})
                for i in range(ranks.BATCH)]
        loss = torch.stack([torch.stack([lo, m["xent"], m["aux"]])
                            for lo, m in rows]).mean(0)
        micro = ranks.BATCH
    else:
        lo, m = models.loss_fn(params, cfg, b)
        loss, micro = torch.stack([lo, m["xent"], m["aux"]]), 1
    _, _, grads = value_and_grad(cfg, microbatches=micro)(params, b)
    return {"loss": loss, "grads": grads,
            "logits": ranks.steps(params, cfg),
            "tokens": ranks.serve(params, cfg), "params": params}


def _jax(cfg, name, kw, params, logits: bool):
    import jax
    import jax.numpy as jnp
    from repro import models as jm
    from repro.configs import get_config as jget
    from _torch_ref import reference_params
    cfg_j = jget(name).reduced().with_(
        **dict(kw, moe_impl="dense") if cfg.is_moe else kw)
    pj = reference_params(params, cfg)
    b = {k: jnp.asarray(v.numpy()) for k, v in ranks.batch(cfg).items()}
    _, m = jax.jit(lambda p, bb: jm.loss_fn(p, cfg_j, bb))(pj, b)
    out = {"xent": float(m["xent"])}
    if logits:
        tokens = b["tokens"]
        bsz, s = tokens.shape
        caches = jm.init_caches(cfg_j, bsz, s + ranks.DECODE_STEPS)
        lg, caches = jm.prefill_fn(pj, cfg_j, {"tokens": tokens}, caches)
        seq = [np.asarray(lg)]
        step = jax.jit(lambda p, t, po, c: jm.decode_fn(p, cfg_j, t, po, c))
        pos = jnp.full((bsz,), s, jnp.int32)
        for i in range(ranks.DECODE_STEPS):
            nxt = jnp.argmax(jnp.asarray(seq[-1]), -1).astype(jnp.int32)
            lg, caches = step(pj, nxt, pos + i, caches)
            seq.append(np.asarray(lg))
        out["logits"] = seq
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("tp_world")
    out_path = str(d / "out.pt")
    ctx = mp.start_processes(ranks.run, args=(str(d / "rdv"), out_path),
                             nprocs=ranks.WORLD, join=False,
                             start_method="spawn")
    try:
        refs = {}
        for tag, (cfg, name, kw) in ranks.configs().items():
            refs[tag] = _one_process(cfg)
            refs[tag]["jax"] = _jax(cfg, name, kw, refs[tag]["params"],
                                    tag in JAX_LOGITS)
    finally:
        _join(ctx, SPAWN_TIMEOUT)
    return torch.load(out_path, weights_only=False), refs


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.mark.parametrize("tag", TAGS)
def test_tp_loss_matches_one_process(world, tag):
    out, refs = world
    _close(out[tag]["loss"], refs[tag]["loss"], **PORT)


@pytest.mark.parametrize("tag", TAGS)
def test_tp_grads_match_one_process(world, tag):
    """Every leaf's gradient, gathered from the ranks' blocks: the
    replicated leaves' (norms, the router, a replicated projection) come
    out whole on every rank only with ``f`` at each column-parallel
    input."""
    from repro_torch.tree import flatten_with_paths
    out, refs = world
    got = dict(flatten_with_paths(out[tag]["grads"]))
    want = dict(flatten_with_paths(refs[tag]["grads"]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert got[path].shape == w.shape, path
        scale = float(w.abs().max())
        _close(got[path], w, rtol=0, atol=1e-4 * scale + 1e-12)


@pytest.mark.parametrize("tag", TAGS)
def test_tp_prefill_and_decode_logits_match_one_process(world, tag):
    out, refs = world
    for got, want in zip(out[tag]["logits"], refs[tag]["logits"]):
        _close(got, want, **PORT)


@pytest.mark.parametrize("tag", TAGS)
def test_tp_engine_tokens_match_one_process(world, tag):
    out, refs = world
    assert out[tag]["tokens"] == refs[tag]["tokens"]
    assert all(len(t) == ranks.MAX_NEW for t in out[tag]["tokens"].values())


@pytest.mark.parametrize("tag", TAGS)
def test_tp_engine_pool_is_the_ranks_block(world, tag):
    """``Engine(mesh=)``'s pool is allocated at the rank's blocks: each
    leaf equals the rank's block of the one-process pool, and where heads
    split over ``model`` the rank holds less than the whole pool."""
    out, _ = world
    equal, mine, whole = out[tag]["pool"]
    assert equal
    assert (mine < whole) == (tag in SPLIT_POOL), (mine, whole)


@pytest.mark.parametrize("tag", TAGS)
def test_tp_loss_stays_vocab_parallel(world, tag):
    """C6: the cross-entropy notes three all-reduces of [B, S] f32 (the
    blocks' max, the exp sum, the gold logit) and gathers nothing: no rank
    holds the whole vocabulary's logits."""
    out, _ = world
    assert out[tag]["xent_notes"] == {
        "all-reduce": (3, 3 * ranks.BATCH * ranks.SEQ * 4)}


@pytest.mark.parametrize("tag", TAGS)
def test_tp_train_step_notes_the_backward_of_each_sum(world, tag):
    """C4: every ``psum`` over ``model`` of the train step notes a second
    all-reduce of the same bytes in the backward; zamba2's split mamba
    heads sum their gated norm's squares once a mamba layer."""
    out, _ = world
    fwd, step = out[tag]["psum_forward"], out[tag]["psum_step"]
    assert step == {k: (2 * n, 2 * b) for k, (n, b) in fwd.items()}
    if tag == "zamba2":
        cfg = ranks.configs()[tag][0]
        mamba = sum(s.kind == "mamba" for s in cfg.pattern())
        assert mamba > 0
        assert fwd == {"all-reduce": (mamba, mamba * ranks.BATCH
                                      * ranks.SEQ * 4)}
    else:
        assert fwd == {}


@pytest.mark.parametrize("tag", ["tied", "gqa_aligned"])
def test_one_rank_loss_is_the_whole_vocab_loss_bit_for_bit(tag):
    """At one rank ``tp.xent``'s max is the block's own log-sum-exp,
    exp(0) = 1 and log(1) = 0: the loss is ``softmax_xent`` of the whole
    logits bit for bit, and so are its gradients to the hidden and the
    head; the model's mesh loss is the no-mesh loss bit for bit."""
    import tempfile
    import torch.distributed as dist
    from repro_torch import models
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.tp import TP, xent
    from repro_torch.models.transformer import softmax_xent
    cfg = ranks.configs()[tag][0]
    b = ranks.batch(cfg)
    rng = np.random.default_rng(7)
    v = cfg.padded_vocab
    x0 = torch.from_numpy(rng.normal(size=(4, 16, 32)).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(32, v)).astype(np.float32))

    def loss_and_grads(fn):
        x, h = x0.clone().requires_grad_(), h0.clone().requires_grad_()
        loss = fn(x, h)
        return (loss.detach(), *torch.autograd.grad(loss, (x, h)))
    mask = b["mask"].float()
    want = loss_and_grads(lambda x, h: softmax_xent(
        (x @ h).float(), b["targets"], mask))
    params = models.init_params(cfg, 0, device="cpu")
    plain, _ = models.loss_fn(params, cfg, b)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/rdv",
                                rank=0, world_size=1)
        try:
            mesh = make_test_mesh((1, 1)).bind(device="cpu")
            got = loss_and_grads(lambda x, h: xent(
                TP(mesh), x, h, v, b["targets"], mask))
            meshed, _ = models.loss_fn(params, cfg, b, mesh=mesh)
        finally:
            dist.destroy_process_group()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(meshed, plain)


@pytest.mark.parametrize("tag", TAGS)
def test_tp_xent_matches_reference(world, tag):
    out, refs = world
    _close(out[tag]["loss"][1], refs[tag]["jax"]["xent"], **JAX_TOL)


@pytest.mark.parametrize("tag", JAX_LOGITS)
def test_tp_logits_match_reference(world, tag):
    out, refs = world
    for got, want in zip(out[tag]["logits"], refs[tag]["jax"]["logits"]):
        _close(got, want, **JAX_TOL)


def test_mla_decode_under_seq_shard_matches_one_process_and_reference(
        world):
    """C9: DeepSeek-V2-Lite decodes under ``decode_kv_seq_shard`` as the
    reference does: every rank attends the whole latent cache.  The rules
    shard ``pos`` along the sequence as the reference's; the port keeps an
    MLA model's ``pos`` whole (``local_cache_specs``), where GSPMD gathers
    it, so the run notes the collectives of the run without the flag and
    nothing more.  Logits within 1e-5 of one process and of JAX's
    unsharded ``decode_fn`` in f32."""
    out, refs = world
    got = out["mla"]["seq_shard"]
    assert got["rules_shard_pos"] and not got["local_shards_pos"]
    assert got["collectives"] == got["plain_collectives"]
    assert len(got["logits"]) == 1 + ranks.DECODE_STEPS
    for g, w in zip(got["logits"], refs["mla"]["logits"]):
        _close(g, w, **PORT)
    for g, w in zip(got["logits"], refs["mla"]["jax"]["logits"]):
        _close(g, w, **PORT)


def test_ranks_hold_their_blocks_of_the_attention(world):
    """Rank 0's first-layer attention leaves are its blocks of the rules'
    specs: a quarter of every projection's features."""
    out, refs = world
    cfg = ranks.configs()["gqa_split"][0]
    d, hd = cfg.d_model, cfg.head_dim_
    heads = out["gqa_split"]["heads"]
    assert heads["layers/0/attn/wq"] == (d, 6 * hd // 4)
    assert heads["layers/0/attn/wk"] == (d, 2 * hd // 4)
    assert heads["layers/0/attn/wo"] == (6 * hd // 4, d)
    mla = out["mla"]["heads"]
    c = ranks.configs()["mla"][0]
    assert mla["layers/0/attn/wkv_b"] == (
        c.kv_lora_rank, c.num_heads * (c.qk_nope_head_dim + c.v_head_dim) // 4)
    assert mla["layers/0/attn/wkv_a"] == (
        c.d_model, c.kv_lora_rank + c.qk_rope_head_dim)   # replicated


@pytest.mark.parametrize("tag,match", [
    ("engine_whole_params", "not the rank's block"),
    ("engine_default", None),
    ("engine_graphs_explicit", None),
    ("ep_a2a_unsplit", "do not split"),
    ("ep_psum_unsplit", "do not split"),
])
def test_mesh_refusals(world, tag, match):
    """A mesh refuses whole params and the EP impls where the experts do
    not split over ``model`` (the encoder-decoder runs tensor
    parallelism: ``test_torch_dryrun.py``); ``Engine(mesh=)`` with
    ``graphs`` at its default (graphs) or ``graphs=True`` serves, the
    tokens of the ``graphs=False`` engine off the mesh (``match`` None;
    on the CPU its steps run eagerly)."""
    out, _ = world
    got = out["refusals"][tag]
    if match is None:
        assert got is None, got
        served = out["served"][tag]
        assert served["graphs"] is True
        assert served["tokens"] == out["gqa_aligned"]["tokens"]
        return
    assert got is not None, f"{tag}: nothing raised"
    assert match in got[1], got


def test_mesh_engine_graphs_serves_the_eager_tokens(world):
    """``Engine(mesh=, graphs=True)`` serves the tokens of
    ``graphs=False`` on the mesh and records the same specialization keys
    (the reference's jit table with a mesh)."""
    out, _ = world
    graphed, eager = (out["served"][t] for t in ("engine_graphs_explicit",
                                                 "engine_eager"))
    assert eager["graphs"] is False
    assert graphed["tokens"] == eager["tokens"]
    assert graphed["keys"] == eager["keys"] and graphed["keys"]


def test_ranks_out_of_step_raise(world):
    """``comm.agree``: a rank whose value differs makes every rank raise
    (the runner's check of the keys its ranks step through)."""
    out, _ = world
    got = out["refusals"]["ranks_out_of_step"]
    assert got is not None and got[0] == "RuntimeError", got
    assert "out of step" in got[1], got


def _jax_attn_decode(window):
    """``ranks.attn_decode``'s step through the reference: the new token
    written at its slot, then ``_sdpa`` in ``"bf16_accum32"`` over the
    whole cache."""
    import jax.numpy as jnp
    from repro.models.attention import _mask_bias, _sdpa
    q, k_new, v_new, pos, cache = ranks.attn_inputs()
    rows = np.arange(ranks.ATTN_ROWS)
    slot = pos.numpy() % ranks.SEQ_SHARD_LEN
    k, v, kv_pos = (cache[n].float().numpy() for n in ("k", "v", "pos"))
    k[rows, slot], v[rows, slot] = k_new[:, 0].float(), v_new[:, 0].float()
    kv_pos = kv_pos.astype(np.int32)
    kv_pos[rows, slot] = pos.numpy()
    bias = _mask_bias(jnp.asarray(pos.numpy())[:, None], jnp.asarray(kv_pos),
                      window, True)
    out = _sdpa(jnp.asarray(q.numpy()), jnp.asarray(k, jnp.bfloat16),
                jnp.asarray(v, jnp.bfloat16), bias, ranks.ATTN_HD ** -0.5,
                "bf16_accum32")
    return np.asarray(out)


@pytest.mark.parametrize("window", ranks.ATTN_WINDOWS)
def test_bf16_accum32_decode_under_seq_shard(world, window):
    """C11: a decode step in ``"bf16_accum32"`` (q f32, a bf16 cache)
    under ``decode_kv_seq_shard`` on the four ranks within 1e-5 of the
    port's unsharded decode: the ranks merge the max and the sum before
    the probabilities are cast to bf16, so both cast the same ones (up to
    the f32 sums' order); and the unsharded decode within 1e-5 of the
    reference's, which casts the same probabilities."""
    out, _ = world
    one = ranks.attn_decode(window)
    _close(out["bf16_seq_shard"][window], one, rtol=0, atol=1e-5)
    _close(one, _jax_attn_decode(window), rtol=0, atol=1e-5)
