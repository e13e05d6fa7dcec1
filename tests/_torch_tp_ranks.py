"""The rank program of ``tests/test_torch_tp.py``: one process of a (1, 4)
gloo world on the CPU (``torch.multiprocessing.spawn`` imports this
module, which imports only torch, numpy and the port).  Every rank runs
every check on the rank's blocks of the params (``local_params``); rank 0
writes what the test process compares (``run``)."""

import numpy as np
import torch

WORLD = 4
SHAPE = (1, 4)
AXES = ("data", "model")

#: the batch: one sequence row a ``model`` rank, so that ``ep_a2a``'s
#: rows of a rank are one row of the batch (``one_process_loss``)
BATCH, SEQ = 4, 16
#: decode steps after the prefill, and the engine's workload
DECODE_STEPS = 2
#: the cache length of ``seq_shard_steps``: a multiple of ``model``
SEQ_SHARD_LEN = 20
PROMPT_LENS, MAX_NEW = (5, 16, 9, 12), 6
BATCH_SEED, PROMPT_SEED = 3, 4
#: ``attn_decode``'s step: rows, q heads, kv heads, head dim,
#: each row's position (the slots before it hold its earlier tokens), the
#: windows, and the seed of its inputs
ATTN_ROWS, ATTN_HEADS, ATTN_KV_HEADS, ATTN_HD = 4, 8, 2, 32
ATTN_POS, ATTN_WINDOWS, ATTN_SEED = (19, 12, 7, 3), (None, 8), 5


def configs():
    """tag -> (port config, the reference config's overrides): reduced, f32,
    dropless (capacity factor = the expert count).

    * ``gqa_split``: q heads (6) and kv heads (2) both cut through a head
      at ``model`` 4 (gathered projections; the rank's kv heads a view of
      a whole cache); 8 experts split over ``model`` (``ep_a2a`` /
      ``ep_psum``).
    * ``gqa_aligned``: 8 q / 4 kv heads, whole heads a rank; 6 experts do
      not split, so each runs the rank's F block (``dense``).
    * ``fsplit_gmm``: the same on ``gmm``, its engine's decode steps on the
      fused ``decode`` impl (each expert's F block there too).
    * ``mla``: DeepSeek-V2-Lite's MLA, one head a rank, shared experts.
    * ``mla_split``: 6 MLA heads, cut through by the column blocks
      (gathered q and ``wkv_b``).
    * ``zamba2``: mamba heads split (the gated norm's sum over ``model``),
      shared attention blocks.
    * ``zamba2_whole``: 2 mamba heads of 128, which do not split: every
      rank runs every head and keeps its channels after the norm.
    * ``tied``: OLMo with a tied embedding (the head is ``embed.T``,
      vocab-parallel)."""
    from repro_torch.configs import get_config
    moe = dict(dtype="float32", num_layers=2)
    out = {
        "gqa_split": ("qwen3-moe-235b-a22b", dict(
            moe, num_heads=6, num_kv_heads=2, num_experts=8,
            moe_capacity_factor=8.0)),
        "gqa_aligned": ("qwen3-moe-235b-a22b", dict(
            moe, num_heads=8, num_kv_heads=4, num_experts=6,
            moe_capacity_factor=6.0)),
        "fsplit_gmm": ("qwen3-moe-235b-a22b", dict(
            moe, num_heads=8, num_kv_heads=4, num_experts=6,
            moe_capacity_factor=6.0, moe_impl="gmm")),
        "mla": ("deepseek-v2-lite", dict(dtype="float32",
                                         moe_capacity_factor=8.0)),
        "mla_split": ("deepseek-v2-lite", dict(
            dtype="float32", moe_capacity_factor=8.0, num_heads=6)),
        "zamba2": ("zamba2-1.2b", dict(dtype="float32")),
        "zamba2_whole": ("zamba2-1.2b", dict(dtype="float32",
                                             ssm_head_dim=128)),
        "tied": ("olmo-1b", dict(dtype="float32", num_layers=2,
                                 tie_embeddings=True)),
    }
    return {tag: (get_config(name).reduced().with_(**kw), name, kw)
            for tag, (name, kw) in out.items()}


def experts_split(cfg) -> bool:
    """The MoE runs expert-parallel (``models.moe.mesh_impl``)."""
    return cfg.is_moe and cfg.num_experts % SHAPE[1] == 0


def layout(cfg) -> str:
    from repro_torch.serving.engine import _supports_paging
    return "paged" if _supports_paging(cfg) else "contiguous"


def batch(cfg):
    from repro_torch import models
    return models.make_train_batch(
        cfg, torch.Generator().manual_seed(BATCH_SEED), BATCH, SEQ,
        device="cpu")


def requests(cfg):
    from repro_torch.serving import Request
    rng = np.random.default_rng(PROMPT_SEED)
    return [Request(uid=i, prompt=rng.integers(
        0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=MAX_NEW)
        for i, n in enumerate(PROMPT_LENS)]


def engine_kw(cfg):
    """The engine both sides build: whole-prompt prefill where the stack
    serves contiguous only (its prompts a multiple of the SSD chunk)."""
    if layout(cfg) == "paged":
        return dict(max_batch=4, max_len=64, prefill_chunk=8,
                    use_moe_decode=cfg.moe_impl == "gmm")
    return dict(max_batch=4, max_len=64, prefill_chunk=0,
                cache_layout="contiguous")


def serve_requests(cfg):
    """``requests``, at lengths a mamba stack's whole prefill takes."""
    reqs = requests(cfg)
    if layout(cfg) == "contiguous":
        for r in reqs:
            r.prompt = np.resize(r.prompt, cfg.ssm_chunk)
    return reqs


def steps(params, cfg, mesh=None, opts=None, max_len=None):
    """Prefill of the batch's tokens, then greedy decode steps -> the
    logits [B, V] of each (the caches contiguous, ``max_len`` positions or
    just enough, the rank's blocks under a mesh: its sequence block under
    ``opts.decode_kv_seq_shard``)."""
    from repro_torch import models
    from repro_torch.models import DEFAULT_OPTS
    from repro_torch.sharding import local_cache_specs, local_tree, named
    opts = DEFAULT_OPTS if opts is None else opts
    tokens = batch(cfg)["tokens"]
    b, s = tokens.shape
    caches = models.init_caches(cfg, b, max_len or s + DECODE_STEPS,
                                device="cpu")
    if mesh is not None:
        caches = local_tree(caches, named(mesh, local_cache_specs(
            caches, cfg, mesh, seq_shard=opts.decode_kv_seq_shard)))
    logits, caches = models.prefill_fn(params, cfg, {"tokens": tokens},
                                       caches, mesh=mesh, opts=opts)
    out = [logits]
    pos = torch.full((b,), s, dtype=torch.int32)
    for i in range(DECODE_STEPS):
        nxt = out[-1].argmax(-1).int()
        lg, caches = models.decode_fn(params, cfg, nxt, pos + i, caches,
                                      mesh=mesh, opts=opts)
        out.append(lg)
    return out


def seq_shard_steps(params, cfg, mesh):
    """``steps`` under ``decode_kv_seq_shard`` on a cache whose length
    splits over ``model`` -> its logits, whether the rules' ``cache_specs``
    and the specs the port runs (``local_cache_specs``) shard ``pos`` over
    ``model``, and the collectives of the run beside those of the same run
    without the flag."""
    from repro_torch import models
    from repro_torch.analysis import record
    from repro_torch.models import ModelOpts
    from repro_torch.sharding import cache_specs, is_spec, local_cache_specs
    from repro_torch.tree import flatten_with_paths
    whole = models.init_caches(cfg, BATCH, SEQ_SHARD_LEN, device="meta")

    def pos_sharded(specs):
        return any("model" in s for p, s in flatten_with_paths(
            specs, is_leaf=is_spec) if p.endswith("pos"))
    out = {"rules_shard_pos": pos_sharded(cache_specs(
        whole, cfg, mesh, seq_shard=True)),
        "local_shards_pos": pos_sharded(local_cache_specs(
            whole, cfg, mesh, seq_shard=True))}
    for flag in (True, False):
        with record() as st:
            logits = steps(params, cfg, mesh,
                           ModelOpts(decode_kv_seq_shard=flag), SEQ_SHARD_LEN)
        out["collectives" if flag else "plain_collectives"] = collectives(st)
        if flag:
            out["logits"] = logits
    return out


def attn_cfg(window):
    """The config ``attn_decode`` reads (head dim, window)."""
    from repro_torch.configs import get_config
    return get_config("qwen3-moe-235b-a22b").reduced().with_(
        num_heads=ATTN_HEADS, num_kv_heads=ATTN_KV_HEADS, head_dim=ATTN_HD,
        sliding_window=window)


def attn_inputs():
    """One decode step's inputs from ``ATTN_SEED``: q [B,1,H,hd] in f32,
    the new k / v [B,1,Hkv,hd] and a whole contiguous cache of
    SEQ_SHARD_LEN slots in bf16 (slot i of row b holds position i below
    the row's position, else -1), the positions [B].  q stays f32 so that
    the output is not rounded: the two decodes' bf16 step is the cast of
    the probabilities."""
    rng = np.random.default_rng(ATTN_SEED)
    b, s = ATTN_ROWS, SEQ_SHARD_LEN

    def draw(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    q = draw(b, 1, ATTN_HEADS, ATTN_HD, scale=2.0)
    k_new, v_new = (draw(b, 1, ATTN_KV_HEADS, ATTN_HD).bfloat16()
                    for _ in range(2))
    pos = torch.tensor(ATTN_POS, dtype=torch.int32)
    slots = torch.arange(s, dtype=torch.int32).expand(b, s)
    cache = {"k": draw(b, s, ATTN_KV_HEADS, ATTN_HD, scale=2.0).bfloat16(),
             "v": draw(b, s, ATTN_KV_HEADS, ATTN_HD).bfloat16(),
             "pos": torch.where(slots < pos[:, None], slots, -1)}
    return q, k_new, v_new, pos, cache


def attn_decode(window, mesh=None):
    """``attn_inputs``' decode step in ``"bf16_accum32"`` through the
    port's decode attention (``_gqa_core``, no rope) -> out [B,1,H,hd]:
    on the whole cache, or under ``mesh`` on the rank's sequence block
    (``_decode_attend_seqshard``)."""
    from repro_torch.models.attention import _gqa_core, _seq_shard
    q, k_new, v_new, pos, cache = attn_inputs()
    shard = None
    if mesh is not None:
        m, r = mesh.shape["model"], mesh.axis_index("model")
        n = SEQ_SHARD_LEN // m
        cache = {k: t[:, r * n:(r + 1) * n].clone() for k, t in cache.items()}
        shard = _seq_shard(mesh, cache)
    out, _ = _gqa_core(attn_cfg(window), q, k_new, v_new, pos, mode="decode",
                       cache=cache, compute_dtype="bf16_accum32",
                       shard=shard, seq_shard_mesh=mesh, rope=False)
    return out


def serve(params, cfg, mesh=None):
    from repro_torch.serving import Engine
    eng = Engine(cfg, params, device="cpu", mesh=mesh, graphs=False,
                 **engine_kw(cfg))
    return {r.uid: list(r.tokens) for r in eng.serve(serve_requests(cfg))}


def pool(cfg, mesh):
    """The engine's pool on the mesh against the rank's blocks of the
    whole pool: (every leaf equal, the rank's bytes, the whole's)."""
    from repro_torch.serving.kv_cache import KVCache
    from repro_torch.sharding import local_cache_specs, local_tree, named
    from repro_torch.tree import leaves
    kw = engine_kw(cfg)
    args = (cfg, kw["max_batch"], kw["max_len"])
    mine = KVCache(*args, layout=layout(cfg), device="cpu", mesh=mesh).caches
    whole = KVCache(*args, layout=layout(cfg), device="cpu").caches
    want = local_tree(whole, named(mesh, local_cache_specs(whole, cfg, mesh)))
    equal = all(a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(leaves(mine), leaves(want)))
    size = lambda tree: sum(x.numel() * x.element_size()  # noqa: E731
                            for x in leaves(tree))
    return equal, size(mine), size(whole)


def collectives(stats):
    """A ``CollectiveStats`` as {kind: (calls, bytes)}."""
    return {k: (stats.count_by_kind[k], stats.bytes_by_kind[k])
            for k in stats.count_by_kind}


def recorded(owner, name: str, fn, axes=None):
    """Run ``fn`` with every call of ``owner.<name>`` (over ``axes``, its
    third argument, if given) recorded apart -> (its result,
    ``collectives`` of what those calls noted; a backward that calls it
    again is recorded too)."""
    from repro_torch.analysis import record
    plain, seen = getattr(owner, name), {}

    def wrapped(*a, **kw):
        if axes is not None and a[2] != axes:
            return plain(*a, **kw)
        with record() as st:
            y = plain(*a, **kw)
        for k, (n, b) in collectives(st).items():
            n0, b0 = seen.get(k, (0, 0))
            seen[k] = (n0 + n, b0 + b)
        return y
    setattr(owner, name, wrapped)
    try:
        return fn(), seen
    finally:
        setattr(owner, name, plain)


def _checks(mesh, out):
    from repro_torch import models
    from repro_torch.models import tp
    from repro_torch.sharding import comm, gather_tree, local_params, \
        local_shardings
    from repro_torch.training import value_and_grad
    for tag, (cfg, _, _) in configs().items():
        params = models.init_params(cfg, 0, device="cpu")
        lp = local_params(params, cfg, mesh)
        (loss, m), xent = recorded(tp, "xent", lambda: models.loss_fn(
            lp, cfg, batch(cfg), mesh=mesh))
        with torch.no_grad():
            _, psum_fwd = recorded(comm, "psum", lambda: models.loss_fn(
                lp, cfg, batch(cfg), mesh=mesh), "model")
        (_, _, grads), psum_step = recorded(
            comm, "psum", lambda: value_and_grad(cfg, mesh=mesh)(
                lp, batch(cfg)), "model")
        out[tag] = {
            "xent_notes": xent, "psum_forward": psum_fwd,
            "psum_step": psum_step,
            "loss": torch.stack([loss, m["xent"], m["aux"]]),
            "grads": gather_tree(grads, local_shardings(params, cfg, mesh)),
            "logits": steps(lp, cfg, mesh),
            "tokens": serve(lp, cfg, mesh),
            "pool": pool(cfg, mesh),
            "heads": {p: tuple(x.shape) for p, x in _attn_leaves(lp)},
        }
        if tag == "mla":
            out[tag]["seq_shard"] = seq_shard_steps(lp, cfg, mesh)
    with torch.no_grad():
        out["bf16_seq_shard"] = {w: attn_decode(w, mesh)
                                 for w in ATTN_WINDOWS}


def _refusals(mesh, out):
    """What a mesh refuses, each as its error's type and message: whole
    params to ``Engine(mesh=)``, ``ep_a2a`` and ``ep_psum`` where the
    experts do not split, ranks out of step (``comm.agree``); and
    ``Engine(mesh=)`` with ``graphs`` at its default, ``True`` and
    ``False``, each of which serves (None under its tag; its ``graphs``,
    tokens and keys under ``out["served"][tag]``)."""
    from repro_torch import models
    from repro_torch.models.moe import moe_ep_a2a, moe_ep_psum
    from repro_torch.serving import Engine
    from repro_torch.sharding import comm, local_params
    got = {}

    def refused(tag, fn):
        try:
            fn()
        except (ValueError, NotImplementedError, RuntimeError) as e:
            got[tag] = (type(e).__name__, str(e))
        else:
            got[tag] = None

    cfg, _, _ = configs()["gqa_aligned"]
    params = models.init_params(cfg, 0, device="cpu")
    lp = local_params(params, cfg, mesh)
    refused("engine_whole_params", lambda: Engine(
        cfg, params, device="cpu", mesh=mesh, graphs=False))
    served = {}

    def serve_with(tag, **kw):
        def fn():
            eng = Engine(cfg, lp, device="cpu", mesh=mesh, **kw,
                         **engine_kw(cfg))
            served[tag] = {
                "graphs": eng.runner.graphs,
                "tokens": {r.uid: list(r.tokens)
                           for r in eng.serve(serve_requests(cfg))},
                "keys": eng.runner.compiled_specializations()}
        refused(tag, fn)
    serve_with("engine_default")
    serve_with("engine_graphs_explicit", graphs=True)
    serve_with("engine_eager", graphs=False)
    out["served"] = served
    # rank 0 alone passes another checksum: every rank raises
    refused("ranks_out_of_step", lambda: comm.agree(
        mesh.axis_index(mesh.axis_names) == 0, mesh, "a test's value"))
    x = torch.zeros((8, cfg.d_model))
    moe = lp["layers"][0]["moe"]
    refused("ep_a2a_unsplit", lambda: moe_ep_a2a(moe, cfg, x, 2, mesh=mesh))
    refused("ep_psum_unsplit", lambda: moe_ep_psum(moe, cfg, x, 2,
                                                   mesh=mesh))
    out["refusals"] = got


def _attn_leaves(params):
    from repro_torch.tree import flatten_with_paths
    return [(p, x) for p, x in flatten_with_paths(params)
            if p.startswith("layers/0/attn/")]


def run(rank: int, rendezvous: str, out_path: str) -> None:
    """One rank: bind the (1, 4) mesh on the CPU, run every check, and
    (rank 0) save the results."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_test_mesh(SHAPE, AXES).bind(device="cpu")
        out = {}
        _checks(mesh, out)
        _refusals(mesh, out)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()
