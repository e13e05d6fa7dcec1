"""The rank program of ``tests/test_torch_ep.py``: one process of a (2, 2)
gloo world on the CPU (``torch.multiprocessing.spawn`` imports this
module, which imports only torch, numpy and the port).  Every rank runs
every check; rank 0 writes what the test process compares (``run``)."""

import os

import numpy as np
import torch

WORLD = 4
SHAPE = (2, 2)
AXES = ("data", "model")

#: the inputs, drawn from these seeds with numpy on both sides
X_SEED, TOKEN_SEED, BATCH_SEED = 1, 2, 1


def moe_cfg():
    """olmoe reduced, f32, 8 experts at top-2, dropless (capacity factor =
    E), as the reference's EP test."""
    from repro_torch.configs import get_config
    return get_config("olmoe-1b-7b").reduced().with_(
        num_experts=8, moe_top_k=2, dtype="float32", moe_capacity_factor=8.0)


def plan_cfg():
    """qwen3-moe reduced at top-4 on ep_a2a, dropless, and its LExI plan
    (k = 1 + i % 4 a MoE layer, the reference's EP plan test)."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-moe-235b-a22b").reduced().with_(
        num_experts=8, moe_top_k=4, dtype="float32", moe_impl="ep_a2a",
        moe_capacity_factor=8.0)
    plan = tuple(1 + (i % 4) for i in range(cfg.num_moe_layers))
    return cfg, cfg.with_lexi_plan(plan)


def decode_cfg():
    """qwen3-moe reduced on ep_a2a (ep_psum in decode), two layers, two kv
    heads, f32, dropless."""
    from repro_torch.configs import get_config
    return get_config("qwen3-moe-235b-a22b").reduced().with_(
        num_experts=8, moe_top_k=2, dtype="float32", moe_impl="ep_a2a",
        moe_capacity_factor=8.0, num_layers=2, num_kv_heads=2)


#: FSDP's size bound in the ``*_fsdp`` runs: the tiny configs' leaves are
#: far below the reference's 2^20 elements
FSDP_MIN = 1024


def train_runs():
    """tag -> (config, ``train`` options): a tiny MoE on ep_a2a, plain and
    with int8 gradient compression, and a tiny dense LM (the reference's
    elastic restore config); each under ZeRO-1 (every mesh run), the
    ``*_fsdp`` ones with ``fsdp_params`` too."""
    from repro_torch.configs import get_config
    from repro_torch.models import ModelOpts
    moe = get_config("olmoe-1b-7b").reduced().with_(
        num_layers=2, dtype="float32", moe_impl="ep_a2a",
        moe_capacity_factor=8.0)
    dense = get_config("olmo-1b").reduced().with_(
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=128, vocab_pad_multiple=16, dtype="float32")
    fsdp = {"opts": ModelOpts(fsdp_params=True, fsdp_min_size=FSDP_MIN)}
    return {"moe": (moe, {}), "moe_int8": (moe, {"compression": True}),
            "dense": (dense, {}), "moe_fsdp": (moe, fsdp),
            "dense_fsdp": (dense, fsdp)}


def one_process_microbatches(cfg) -> int:
    """The one-process run a mesh run equals: under EP each rank's aux is
    over its own rows (its ``model`` block of its data block), as one
    microbatch a rank's rows; a dense LM's mesh step is the step on the
    global batch."""
    return WORLD if cfg.moe_impl == "ep_a2a" else 1


TRAIN_STEPS, CKPT_EVERY = 4, 2


def data_cfg(cfg):
    from repro_torch.data import DataConfig
    return DataConfig(cfg.vocab_size, seq_len=16, global_batch=8, seed=0)


def optimizer():
    from repro_torch.optim import AdamW
    return AdamW(peak_lr=1e-3, total_steps=TRAIN_STEPS, warmup_steps=1)


def moe_input(cfg):
    return torch.from_numpy(np.random.default_rng(X_SEED).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32))


def decode_tokens(cfg):
    return torch.from_numpy(np.random.default_rng(TOKEN_SEED).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))


def _moe_checks(mesh, out):
    from repro_torch import models
    from repro_torch.models.moe import moe
    from repro_torch.sharding import Sharding, comm, local_params
    cfg = moe_cfg()
    params = models.init_params(cfg, 0, device="cpu")
    mp = params["layers"][0]["moe"]
    mpl = local_params(params, cfg, mesh)["layers"][0]["moe"]
    x = moe_input(cfg)
    d = cfg.d_model
    x2d = x.reshape(-1, d)
    every = Sharding(mesh, (AXES,))          # a rank's own rows
    data = Sharding(mesh, ("data",))         # over data, same on model
    xa, xp = every.local(x2d), data.local(x2d)
    k = cfg.moe_top_k
    for chunks in (1, 2):
        y, aux = moe(mpl, cfg, xp[None], k, impl="ep_a2a", mesh=mesh,
                     a2a_chunks=chunks)
        out[f"a2a_y_c{chunks}"] = comm.all_gather(y[0], mesh, "data")
        out[f"a2a_aux_c{chunks}"] = aux
    # each rank's aux over its own rows, on the plain dense path
    aux_r = moe(mp, cfg, xa[None], k, impl="dense")[1]
    out["a2a_aux_ranks"] = comm.all_gather(aux_r[None], mesh, AXES)
    y, aux = moe(mpl, cfg, xp[None], k, impl="ep_psum", mesh=mesh)
    out["psum_y"] = comm.all_gather(y[0], mesh, "data")
    out["psum_aux"] = aux
    aux_d = moe(mp, cfg, xp[None], k, impl="dense")[1]
    out["psum_aux_ranks"] = comm.all_gather(aux_d[None], mesh, "data")
    y0, aux0 = moe(mp, cfg, x, k, impl="dense")
    out["dense_y"], out["dense_aux"] = y0.reshape(-1, d), aux0

    # gradients of sum(y^2) + 0.01 aux: each data block's share (the same
    # on its model ranks), reduced as the train step does (over the data
    # axes), the expert slices gathered
    live = {n: t.detach().clone().requires_grad_() for n, t in mpl.items()}
    y, aux = moe(live, cfg, xp[None], k, impl="ep_a2a", mesh=mesh)
    share = y.square().sum() + 0.01 * aux / mesh.shape["data"]
    names = sorted(live)
    grads = torch.autograd.grad(share, [live[n] for n in names])
    ep = {}
    for n, g in zip(names, grads):
        g = comm.psum(g, mesh, "data")
        if n in ("w1", "w2"):
            g = comm.all_gather(g, mesh, "model")
        ep[n] = g
    out["a2a_grads"] = ep
    # the one-process side: the dense path on the same four token blocks
    whole = {n: t.detach().clone().requires_grad_() for n, t in mp.items()}
    blocks = x2d.reshape(WORLD, -1, d)
    ys, auxs = zip(*(moe(whole, cfg, b[None], k, impl="dense")
                     for b in blocks))
    loss = sum(yy.square().sum() for yy in ys) + 0.01 * torch.stack(
        auxs).mean()
    out["dense_grads"] = dict(zip(names, torch.autograd.grad(
        loss, [whole[n] for n in names])))


def _pod_checks(out):
    """The same MoE layer on a (1, 2, 2) ("pod", "data", "model") mesh of
    this world: two data axes, so ep_psum's aux and the data group span
    a group over several axes."""
    from repro_torch import models
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.moe import moe
    from repro_torch.sharding import Sharding, comm, local_params
    mesh = make_test_mesh((1, 2, 2), ("pod", "data", "model")).bind(
        device="cpu")
    cfg = moe_cfg()
    params = models.init_params(cfg, 0, device="cpu")
    mpl = local_params(params, cfg, mesh)["layers"][0]["moe"]
    x2d = moe_input(cfg).reshape(-1, cfg.d_model)
    data = Sharding(mesh, (("pod", "data"),))
    k = cfg.moe_top_k
    y, aux = moe(mpl, cfg, data.local(x2d)[None], k, impl="ep_a2a",
                 mesh=mesh)
    out["pod_a2a_y"] = comm.all_gather(y[0], mesh, ("pod", "data"))
    out["pod_a2a_aux"] = aux
    y, aux = moe(mpl, cfg, data.local(x2d)[None], k, impl="ep_psum",
                 mesh=mesh)
    out["pod_psum_y"] = comm.all_gather(y[0], mesh, ("pod", "data"))
    out["pod_psum_aux"] = aux


def _plan_checks(mesh, out):
    from repro_torch import models
    from repro_torch.analysis import record
    from repro_torch.sharding import Sharding, comm, local_params
    base, planned = plan_cfg()
    params = models.init_params(base, 0, device="cpu")
    lp = local_params(params, base, mesh)
    batch = models.make_train_batch(
        base, torch.Generator().manual_seed(BATCH_SEED), 4, 32, device="cpu")
    every = Sharding(mesh, (AXES,))
    data = Sharding(mesh, ("data",))
    block = {n: data.local(v) for n, v in batch.items()}
    own = {n: every.local(v) for n, v in batch.items()}
    for tag, cfg in (("base", base), ("plan", planned)):
        with record() as stats:
            loss, m = models.loss_fn(lp, cfg, block, mesh=mesh)
        out[f"{tag}_a2a_bytes"] = stats.bytes_by_kind["all-to-all"]
        out[f"{tag}_a2a_count"] = stats.count_by_kind["all-to-all"]
        got = torch.stack([loss, m["xent"], m["aux"]])
        out[f"{tag}_ep"] = comm.all_gather(got[None], mesh, AXES)
        # the one-process dense path (no mesh) on each rank's own row
        l1, m1 = models.loss_fn(params, cfg, own)
        out[f"{tag}_dense_rows"] = comm.all_gather(
            torch.stack([l1, m1["xent"], m1["aux"]])[None], mesh, AXES)
        out[f"{tag}_dense_full"] = models.loss_fn(params, cfg, batch)[1][
            "xent"]


def _decode_checks(mesh, out):
    from repro_torch import models
    from repro_torch.models import ModelOpts
    from repro_torch.sharding import Sharding, comm, gather_tree, \
        local_cache_specs, local_params, local_tree, named
    cfg = decode_cfg()
    params = models.init_params(cfg, 0, device="cpu")
    lp = local_params(params, cfg, mesh)
    tokens = decode_tokens(cfg)
    b, plen = tokens.shape
    s_max = 32
    # the plain one-process steps
    caches = models.init_caches(cfg, b, s_max, layout="contiguous",
                                device="cpu")
    logits, caches = models.prefill_fn(params, cfg, {"tokens": tokens},
                                       caches)
    pos = torch.full((b,), plen, dtype=torch.int32)
    nxt = logits.argmax(-1).int()
    l0, caches = models.decode_fn(params, cfg, nxt, pos, caches)
    n2 = l0.argmax(-1).int()
    l0b, caches = models.decode_fn(params, cfg, n2, pos + 1, caches)
    out["plain_logits"] = [logits, l0, l0b]
    # the rank's rows and sequence block, prefilled and decoded on the mesh
    opts = ModelOpts(decode_kv_seq_shard=True)
    rows = Sharding(mesh, ("data",))
    empty = models.init_caches(cfg, b, s_max, layout="contiguous",
                               device="cpu")
    shard = named(mesh, local_cache_specs(empty, cfg, mesh, seq_shard=True))
    mine = local_tree(empty, shard)
    lg, mine = models.prefill_fn(lp, cfg, {"tokens": rows.local(tokens)},
                                 mine, mesh=mesh, opts=opts)
    prefill_block = local_tree(models.prefill_fn(
        params, cfg, {"tokens": tokens}, models.init_caches(
            cfg, b, s_max, layout="contiguous", device="cpu"))[1], shard)
    out["prefill_cache_diff"] = comm.all_gather(torch.tensor([[max(
        float((a[k].double() - w[k].double()).abs().max()) for k in a)
        for a, w in zip(mine, prefill_block)]]), mesh, AXES)
    # the sequence-sharded write is the rank's sequence block of the same
    # mesh prefill's whole-sequence cache, bit for bit
    heads = named(mesh, local_cache_specs(empty, cfg, mesh))
    _, written = models.prefill_fn(lp, cfg, {"tokens": rows.local(tokens)},
                                   local_tree(empty, heads), mesh=mesh)
    seq_block = local_tree(gather_tree(written, heads), shard)
    out["prefill_cache_equal"] = comm.all_gather(torch.tensor([[all(
        torch.equal(a[k], w[k]) for k in a)
        for a, w in zip(mine, seq_block)]]), mesh, AXES)
    la, mine = models.decode_fn(lp, cfg, rows.local(nxt), rows.local(pos),
                                mine, mesh=mesh, opts=opts)
    lb, mine = models.decode_fn(lp, cfg, rows.local(n2),
                                rows.local(pos + 1), mine, mesh=mesh,
                                opts=opts)
    out["mesh_logits"] = [comm.all_gather(t, mesh, "data")
                          for t in (lg, la, lb)]


def _train_checks(mesh, out, ckpt_root):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.sharding import gather_tree
    from repro_torch.training import train, whole_shardings
    from repro_torch.models import DEFAULT_OPTS
    for tag, (cfg, kw) in train_runs().items():
        ck = os.path.join(ckpt_root, tag)
        res = train(cfg, data_cfg(cfg), total_steps=TRAIN_STEPS,
                    optimizer=optimizer(), mesh=mesh, device="cpu",
                    ckpt_dir=ck, ckpt_every=CKPT_EVERY, ckpt_async=False,
                    **kw)
        shardings = whole_shardings(cfg, mesh, kw.get("opts", DEFAULT_OPTS),
                                    kw.get("compression", False))
        whole = gather_tree(res.state, shardings)
        # elastic restore on this world: each rank's block of the
        # checkpoint equals its own state
        back, meta = CheckpointManager(ck).restore(whole,
                                                   shardings=shardings)
        same = all(torch.equal(a, b) for a, b in zip(
            _tensors(back), _tensors(res.state)))
        out[f"train_{tag}"] = {"losses": res.losses,
                               "params": whole.params,
                               "restore_step": meta["step"],
                               "restore_equal": same,
                               "blocks": _blocks(res.state.params),
                               "mu_blocks": _blocks(res.state.opt.mu)}


def _blocks(params):
    """Rank 0's shape of each param leaf (its blocks)."""
    from repro_torch.tree import flatten_with_paths
    return {p: tuple(x.shape) for p, x in flatten_with_paths(params)}


def _tensors(tree):
    from repro_torch.tree import leaves
    return [t for t in leaves(tree) if isinstance(t, torch.Tensor)]


def run(rank: int, rendezvous: str, out_path: str, ckpt_root: str) -> None:
    """One rank: bind the (2, 2) mesh on the CPU, run every check, and
    (rank 0) save the results."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_test_mesh(SHAPE, AXES).bind(device="cpu")
        out = {"coords": mesh.coordinates()}
        _moe_checks(mesh, out)
        _pod_checks(out)
        _plan_checks(mesh, out)
        _decode_checks(mesh, out)
        _train_checks(mesh, out, ckpt_root)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()
