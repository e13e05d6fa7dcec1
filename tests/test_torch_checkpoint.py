"""The port's checkpoints and fault-tolerant loop (``checkpoint/manager.py``,
``training/loop.py``), as the reference's ``tests/test_train.py`` holds its
own: a run killed at step 12 and resumed equals the uninterrupted run bit
for bit on the CPU; checkpoints are atomic, keep N, save asynchronously,
refuse a shape mismatch and ignore a leftover ``.tmp`` dir; a bf16 leaf
round-trips as its raw bits (numpy has no bfloat16); a restore lands on
the device asked for, from ``meta`` tensors too; the reference's layout
(``step_<N>/meta.json`` + path-keyed ``arrays.npz``) is kept.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_thread  # noqa: F401,E402


def _tiny():
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    cfg = get_config("olmoe-1b-7b").reduced().with_(
        num_layers=2, d_model=64, num_experts=4, moe_top_k=2,
        vocab_size=128)
    return cfg, DataConfig(cfg.vocab_size, seq_len=32, global_batch=8)


@pytest.mark.parametrize("ckpt_async", [False, True])
def test_crash_resume_bit_exact(tmp_path, ckpt_async):
    """Killed at step 12, resumed from step 10: the params, moments and
    losses of steps 11-20 equal the uninterrupted run's."""
    from repro_torch.optim import AdamW
    from repro_torch.training import train
    from repro_torch.tree import leaves
    cfg, dc = _tiny()
    kw = dict(total_steps=20, optimizer=AdamW(peak_lr=1e-3, total_steps=20),
              device="cpu", compression=ckpt_async)
    d = str(tmp_path / "crash")
    with pytest.raises(RuntimeError, match="injected crash"):
        train(cfg, dc, ckpt_dir=d, ckpt_every=5, ckpt_async=ckpt_async,
              crash_at_step=12, **kw)
    resumed = train(cfg, dc, ckpt_dir=d, ckpt_every=5, ckpt_async=ckpt_async,
                    **kw)
    assert resumed.resumed_from == 10 and resumed.steps_run == 10
    clean = train(cfg, dc, **kw)
    assert resumed.losses == clean.losses[10:]
    assert resumed.state.opt.step == clean.state.opt.step == 20
    for a, b in zip(leaves(clean.state), leaves(resumed.state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def test_checkpoint_atomic_keep_n_and_layout(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    tree = {"w": torch.arange(8.0), "layers": [{"b": torch.ones(2, 3)}],
            "n": 7}
    for s in (5, 10, 15):
        mgr.save(s, tree, extra={"s": s})
    assert mgr.all_steps() == [10, 15]
    restored, meta = mgr.restore(tree, step=15)
    assert torch.equal(restored["w"], tree["w"])
    assert torch.equal(restored["layers"][0]["b"], tree["layers"][0]["b"])
    assert restored["n"] == 7 and meta["step"] == 15 and meta["extra"] == {
        "s": 15}
    d = tmp_path / "ck" / "step_00000015"
    assert sorted(os.listdir(d)) == ["arrays.npz", "meta.json"]
    with np.load(d / "arrays.npz") as z:
        assert sorted(z.files) == ["layers/0/b", "n", "w"]
    assert json.loads((d / "meta.json").read_text())["dtypes"]["w"] == \
        "float32"


def test_async_save_snapshots_before_the_tree_changes(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ck"))
    w = torch.ones(4)
    mgr.save(1, {"w": w}, blocking=False)
    w.add_(1.0)                 # the train step updates params in place
    mgr.wait()
    assert mgr.latest_step() == 1
    assert torch.equal(mgr.restore({"w": w})[0]["w"], torch.ones(4))


def test_restore_shape_mismatch_raises(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"w": torch.ones(5)})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore({"v": torch.ones(4)})


def test_tmp_dir_crash_is_invisible(tmp_path):
    """A leftover .tmp dir (a crash mid-write) must not be restorable."""
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, {"w": torch.ones(2)})
    os.makedirs(str(tmp_path / "ck" / "step_00000009.tmp"))
    assert mgr.latest_step() == 3


def test_bf16_leaf_round_trips_as_raw_bits(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ck"))
    g = torch.Generator().manual_seed(0)
    w = torch.randn(3, 5, generator=g).bfloat16()
    w[0, 0] = float("inf")
    w[0, 1] = -0.0
    mgr.save(2, {"w": w, "f": torch.zeros(2, dtype=torch.int8)})
    meta = json.loads((tmp_path / "ck" / "step_00000002" / "meta.json")
                      .read_text())
    assert meta["dtypes"] == {"w": "bfloat16", "f": "int8"}
    # restored onto the device asked for, from a like tree of meta tensors
    like = {"w": torch.empty(3, 5, dtype=torch.bfloat16, device="meta"),
            "f": torch.empty(2, dtype=torch.int8, device="meta")}
    out, _ = mgr.restore(like, device="cpu")
    assert out["w"].dtype == torch.bfloat16 and out["w"].device.type == "cpu"
    assert torch.equal(out["w"].view(torch.int16), w.view(torch.int16))
    assert out["f"].dtype == torch.int8


def test_train_state_round_trips(tmp_path):
    """A whole train state (params, moments, step, error state) saved and
    restored equals itself; the loop resumes from the final checkpoint
    without running a step."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.optim import AdamW
    from repro_torch.training import train
    from repro_torch.tree import flatten_with_paths
    cfg, dc = _tiny()
    d = str(tmp_path / "run")
    res = train(cfg, dc, total_steps=3, device="cpu", ckpt_dir=d,
                compression=True)
    mgr = CheckpointManager(d)
    assert mgr.latest_step() == 3
    out, meta = mgr.restore(res.state)
    assert meta["extra"] == {"final": True}
    want = dict(flatten_with_paths(res.state))
    for key, leaf in flatten_with_paths(out):
        if isinstance(leaf, torch.Tensor):
            assert torch.equal(leaf, want[key]), key
        else:
            assert leaf == want[key] == 3
    again = train(cfg, dc, total_steps=3, device="cpu", ckpt_dir=d,
                  compression=True, optimizer=AdamW(total_steps=3))
    assert again.resumed_from == 3 and again.steps_run == 0
