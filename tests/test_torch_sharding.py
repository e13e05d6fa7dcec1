"""The port's sharding rules, collective accounting and mesh against the
JAX reference, in this process (no world; one rank for the binding
checks).

* ``param_specs`` (plain and ``fsdp=True``) for every ``ASSIGNED`` config
  at full size, on ``models.abstract_params`` (meta tensors) on both
  sides: a port leaf's spec equals the reference's with the stacked layer
  dim dropped (a run of one layer has none in either tree).  The
  reference reads only ``axis_names`` and ``devices.shape`` of its mesh,
  so a stub of those stands in for 8 devices.
* ``opt_state_specs``, ``batch_spec`` and ``cache_specs`` (contiguous,
  paged, ``seq_shard=True``) the same way.
* ``CollectiveStats`` conventions against ``repro.analysis.hlo``'s parse
  of the same collectives.
* ``moe(impl="ep_a2a" / "ep_psum")`` with no mesh equals ``dense``.
* A mesh whose world size is wrong raises; a bound mesh with no
  ``device=`` asks for CUDA.

Specs are compared exactly; the moe outputs bitwise (the same function).
"""

import os
from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402

from repro_torch.configs import ASSIGNED  # noqa: E402

MESH = (2, 4)


class _StubMesh:
    """What the reference's rules read of a ``jax.sharding.Mesh``."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(shape)


def _meshes(shape=MESH, axes=("data", "model")):
    from repro_torch.launch.mesh import make_test_mesh
    return _StubMesh(shape, axes), make_test_mesh(shape, axes)


@lru_cache(maxsize=None)
def _abstract(name):
    from repro import models as jm
    from repro.configs import get_config as jget
    from repro_torch import models as tm
    from repro_torch.configs import get_config as tget
    cfg_j, cfg_t = jget(name), tget(name)
    return cfg_j, cfg_t, jm.abstract_params(cfg_j), tm.abstract_params(cfg_t)


def _ref_leaves(tree, is_leaf=None):
    """{path: leaf} of a reference tree, paths as the port's."""
    import jax
    from repro.sharding.rules import _path_str
    return {_path_str(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _ref_spec(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def _layer_map(cfg):
    """Port layer index -> (reference group index, stacked?)."""
    from repro_torch.models.blocks import group_pattern
    out = {}
    for gi, g in enumerate(group_pattern(cfg.pattern())):
        for i in range(g.start, g.start + g.count):
            out[i] = (gi, g.count > 1)
    return out


def _ref_param_path(path, layers):
    """A port param path -> (the reference's path, stacked?)."""
    parts = path.split("/", 2)
    if parts[0] == "layers":
        gi, stacked = layers[int(parts[1])]
        return f"stack/groups/{gi}/{parts[2]}", stacked
    if parts[0] == "shared_attn":
        return f"stack/{path}", False
    return path, False


def _compare(port_specs, ref_specs, ref_shapes, port_tree, path_map):
    """Every port leaf's spec == the reference's, the stacked dim
    dropped; every reference leaf is met."""
    from repro_torch.sharding import is_spec
    from repro_torch.tree import flatten_with_paths
    specs = dict(flatten_with_paths(port_specs, is_leaf=is_spec))
    seen = set()
    for path, leaf in flatten_with_paths(port_tree):
        rpath, stacked = path_map(path)
        want = _ref_spec(ref_specs[rpath], len(ref_shapes[rpath].shape))
        if stacked:
            want = want[1:]
        assert specs[path] == want, (path, specs[path], want)
        assert len(specs[path]) == leaf.dim(), path
        seen.add(rpath)
    assert seen == set(ref_specs), set(ref_specs) ^ seen


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", ASSIGNED)
def test_param_specs_match_reference(name, fsdp):
    from jax.sharding import PartitionSpec as P
    from repro.sharding import rules as jrules
    from repro_torch.sharding import param_specs
    cfg_j, cfg_t, pj, pt = _abstract(name)
    stub, mesh = _meshes()
    ref = jrules.param_specs(pj, cfg_j, stub, fsdp=fsdp)
    layers = _layer_map(cfg_t)
    _compare(param_specs(pt, cfg_t, mesh, fsdp=fsdp),
             _ref_leaves(ref, is_leaf=lambda x: isinstance(x, P)),
             _ref_leaves(pj), pt, lambda p: _ref_param_path(p, layers))


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b",
                                  "llama4-scout-17b-a16e", "whisper-base"])
def test_opt_state_specs_match_reference(name):
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.optim import AdamW as JAdamW
    from repro.sharding import rules as jrules
    from repro_torch.optim import AdamWState
    from repro_torch.sharding import opt_state_specs, param_specs
    cfg_j, cfg_t, pj, pt = _abstract(name)
    stub, mesh = _meshes()
    sj = jax.eval_shape(lambda: JAdamW().init(pj))
    ref = jrules.opt_state_specs(sj, jrules.param_specs(pj, cfg_j, stub),
                                 stub)
    got = opt_state_specs(AdamWState(step=0, mu=pt, nu=pt),
                          param_specs(pt, cfg_t, mesh), mesh)
    assert got.step == () and tuple(ref.step) == ()
    layers = _layer_map(cfg_t)
    for field in ("mu", "nu"):
        _compare(getattr(got, field),
                 _ref_leaves(getattr(ref, field),
                             is_leaf=lambda x: isinstance(x, P)),
                 _ref_leaves(pj), pt, lambda p: _ref_param_path(p, layers))


@pytest.mark.parametrize("shape,axes", [((2, 4), ("data", "model")),
                                        ((2, 16, 16),
                                         ("pod", "data", "model"))])
def test_batch_spec_matches_reference(shape, axes):
    from repro.sharding import rules as jrules
    from repro_torch.sharding import batch_spec, tokens_spec
    stub, mesh = _meshes(shape, axes)
    for s in [(), (8,), (32, 16), (1, 4096), (3, 7, 5), (64, 2, 2, 2)]:
        want = _ref_spec(jrules.batch_spec(s, stub), len(s))
        assert batch_spec(s, mesh) == want == tokens_spec(s, mesh), s


def _ref_cache_path(path, layers):
    head, rest = path.split("/", 1)
    gi, stacked = layers[int(head)]
    return f"{gi}/{rest}", stacked


_CACHE_CASES = [(n, lay, seq) for n in ("qwen3-moe-235b-a22b",
                                         "zamba2-1.2b", "minicpm3-4b")
                for lay, seq in (("contiguous", False), ("contiguous", True),
                                 ("paged", False))] + [
    # the encoder-decoder's caches are contiguous only
    ("whisper-base", "contiguous", False), ("whisper-base", "contiguous",
                                            True)]


@pytest.mark.parametrize("name,layout,seq_shard", _CACHE_CASES)
def test_cache_specs_match_reference(name, layout, seq_shard):
    from jax.sharding import PartitionSpec as P
    from repro import models as jm
    from repro.sharding import rules as jrules
    from repro_torch import models as tm
    from repro_torch.sharding import cache_specs
    cfg_j, cfg_t, _, _ = _abstract(name)
    stub, mesh = _meshes()
    kw = dict(layout=layout, page_size=16, num_pages=10)
    if cfg_t.is_encoder_decoder:
        kw = {}
    cj = jm.abstract_caches(cfg_j, 8, 64, **kw)
    ct = tm.init_caches(cfg_t, 8, 64, device="meta", **kw)
    ref = jrules.cache_specs(cj, cfg_j, stub, seq_shard=seq_shard)
    got = cache_specs(ct, cfg_t, mesh, seq_shard=seq_shard)
    if cfg_t.is_encoder_decoder:
        path_map = lambda p: (p, False)                 # noqa: E731
    else:
        layers = _layer_map(cfg_t)
        path_map = lambda p: _ref_cache_path(p, layers)  # noqa: E731
    _compare(got, _ref_leaves(ref, is_leaf=lambda x: isinstance(x, P)),
             _ref_leaves(cj), ct, path_map)


def test_collective_stats_conventions_match_reference():
    """The reference parses these collectives out of HLO text; the port
    counts the same calls as its collectives report them (result bytes
    and group size)."""
    from repro.analysis.hlo import collective_stats
    from repro_torch.analysis import CollectiveStats
    text = """
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), replica_groups={{0,1,2,3}}
  %art = (f32[256]{0}, bf16[512]{0}) all-reduce(%a, %b), replica_groups=[2,4]<=[8]
  %a2a = (f32[1,2,12,128]{3,2,1,0}, f32[1,2,12,128]{3,2,1,0}) all-to-all(%p, %q), dimensions={0}
  %ag = bf16[2,512,128]{2,1,0} all-gather(bf16[2,128,128]{2,1,0} %y), replica_groups=[2,4]<=[8], dimensions={1}
  %agd = f32[8]{0} all-gather-done(%st)
  %rs = f32[64]{0} reduce-scatter(f32[64]{0} %z), replica_groups={{0,1}}
"""
    want = collective_stats(text)
    got = CollectiveStats()
    got.add("all-reduce", 1024 * 4, 4)
    got.add("all-reduce", 256 * 4 + 512 * 2, 4)
    got.add("all-to-all", 2 * (1 * 2 * 12 * 128 * 4), 4)
    got.add("all-gather", 2 * 512 * 128 * 2, 4)
    got.add("reduce-scatter", 64 * 4, 2)
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.count_by_kind == want.count_by_kind
    assert (got.total_bytes, got.total_count) == (want.total_bytes,
                                                  want.total_count)
    assert got.summary() == want.summary()


def test_record_counts_nested_blocks():
    from repro_torch.analysis import record
    from repro_torch.analysis.collectives import note
    with record() as outer:
        note("all-to-all", 100, 2)
        with record() as inner:
            note("all-gather", 64, 4)
    note("all-reduce", 8)                         # outside every block
    assert outer.bytes_by_kind == {"all-to-all": 100, "all-gather": 16}
    assert inner.bytes_by_kind == {"all-gather": 16}
    with pytest.raises(ValueError, match="unknown collective"):
        outer.add("broadcast", 8)


@pytest.mark.parametrize("impl", ["ep_a2a", "ep_psum"])
def test_ep_impls_without_a_mesh_run_dense(impl):
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe
    cfg = get_config("olmoe-1b-7b").reduced().with_(dtype="float32")
    mp = models.init_params(cfg, 0, device="cpu")["layers"][0]["moe"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    y, aux = moe(mp, cfg, x, 2, impl=impl)
    y0, aux0 = moe(mp, cfg, x, 2, impl="dense")
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


def test_local_specs_shard_only_the_experts():
    """The specs the port runs are the rules' whole specs (tensor,
    expert and FSDP entries; once the port ran only the expert entries):
    ``local_specs`` equals ``param_specs`` (plain and FSDP) for every
    assigned config at the production (16, 16) mesh, and every sharded
    dim divides over its axes.  Where the experts do not split over
    ``model``, each expert's F does (w1's fused columns, w2's rows)."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import is_spec, local_specs, param_specs
    from repro_torch.tree import flatten_with_paths
    mesh = make_production_mesh()
    for name in ASSIGNED:
        cfg = get_config(name)
        pt = models.abstract_params(cfg)
        shapes = dict(flatten_with_paths(pt))
        for fsdp in (False, True):
            run = dict(flatten_with_paths(local_specs(pt, cfg, mesh, fsdp),
                                          is_leaf=is_spec))
            full = dict(flatten_with_paths(param_specs(pt, cfg, mesh,
                                                       fsdp=fsdp),
                                           is_leaf=is_spec))
            assert run == full, name
            for p, spec in run.items():
                for dim, e in zip(shapes[p].shape, spec):
                    axes = () if e is None else (
                        e if isinstance(e, tuple) else (e,))
                    n = int(np.prod([mesh.shape[a] for a in axes]))
                    assert dim % n == 0, (name, p, spec)
    six = get_config("qwen3-moe-235b-a22b").with_(num_experts=6)
    _, small = _meshes()
    run = dict(flatten_with_paths(local_specs(
        models.abstract_params(six), six, small), is_leaf=is_spec))
    assert run["layers/0/moe/w1"] == (None, None, "model")
    assert run["layers/0/moe/w2"] == (None, "model", None)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "zamba2-1.2b"])
def test_local_cache_specs_keep_the_kv_heads(name, layout):
    """The caches the port runs keep ``cache_specs``' kv-head (and mamba
    state-head) entries over ``model``."""
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.sharding import cache_specs, is_spec, local_cache_specs
    from repro_torch.tree import flatten_with_paths
    cfg = get_config(name).reduced()
    _, mesh = _meshes()
    if layout == "paged" and name == "zamba2-1.2b":
        layout = "contiguous"          # a mamba stack serves contiguous
    ct = models.init_caches(cfg, 8, 64, layout=layout, page_size=16,
                            num_pages=10, device="meta")
    got = dict(flatten_with_paths(local_cache_specs(ct, cfg, mesh),
                                  is_leaf=is_spec))
    assert got == dict(flatten_with_paths(cache_specs(ct, cfg, mesh),
                                          is_leaf=is_spec))
    heads = [p for p, s in got.items() if "model" in s]
    assert heads, got
    for p in heads:
        assert p.split("/")[-1] in ("k", "v", "kp", "vp", "state"), p


@pytest.fixture
def one_rank(tmp_path):
    """A world of one rank over gloo in this process, torn down after."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        str(tmp_path), "rdv"), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_binding_refuses_the_wrong_world_and_defaults_to_cuda(one_rank):
    from repro_torch.launch.mesh import chips, make_production_mesh, \
        make_test_mesh
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    big = make_production_mesh(multi_pod=True)
    assert big.axis_names == ("pod", "data", "model") and chips(big) == 512
    with pytest.raises(RuntimeError, match="bind it"):
        make_test_mesh((2, 2)).get_group("model")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_test_mesh((2, 2)).bind(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_test_mesh((1, 1)).bind()
    mesh = make_test_mesh((1, 1)).bind(device="cpu")
    assert mesh.coordinates() == (0, 0) and mesh.axis_index("model") == 0
    assert mesh.device == torch.device("cpu")
