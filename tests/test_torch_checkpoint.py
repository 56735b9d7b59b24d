"""The port's checkpoint store (``repro_torch.checkpoint``), mirroring every
case of tests/test_checkpoint.py: round trip, a torn ``.tmp`` ignored, the
checksum, garbage collection, async saves and their failures surfacing on
``wait`` and on the next save, the newest-first fallback past a corrupt
checkpoint; the elastic load on a (1, 2) gloo mesh (each rank's leaves its
slices by ``convert.lm_shardings``, equal to ``LM(cfg, mesh=...)``'s own);
and across packages, in the one on-disk format: a checkpoint the reference
writes loads in the port bit for bit (bf16, fp32, int32, a named tuple's
fields), and one the port writes loads in the reference bit for bit.
"""

import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train_ranks as TR
from repro_torch.checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from repro_torch.checkpoint import store
from repro_torch.checkpoint.store import AsyncCheckpointError, latest_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores, and the
    small ops here lose more to a crowded thread pool than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class State(NamedTuple):
    step: object
    mu: object


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.bfloat16) * 1.5,
                       "c": torch.tensor(7, dtype=torch.int32)},
            "opt": State(torch.tensor(3, dtype=torch.int32), {"w": torch.full((2, 2), -0.25)})}


def _leaves(tree) -> dict:
    return store._flatten(tree)


def _assert_same(got, want):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert torch.equal(g[k], w[k]), k


def test_save_load_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 3, t)
    out, manifest = load_checkpoint(tmp_path, t)
    assert manifest["step"] == 3
    _assert_same(out, t)
    assert isinstance(out["opt"], State)


def test_atomicity_tmp_ignored(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 1, t)
    bad = tmp_path / "step_0000000002.tmp"  # a torn write
    bad.mkdir()
    (bad / "junk.npy").write_bytes(b"broken")
    assert latest_step(tmp_path) == 1
    assert load_checkpoint(tmp_path, t)[1]["step"] == 1


def test_checksum_detects_corruption(tmp_path):
    t = _tree()
    path = save_checkpoint(tmp_path, 1, t)
    target = path / "a.npy"
    np.save(target, np.load(target) + 1)
    with pytest.raises(IOError, match="checksum"):
        load_checkpoint(tmp_path, t)


def test_corrupt_newest_falls_back_to_older(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 1, t)
    path = save_checkpoint(tmp_path, 2, t)
    (path / "a.npy").write_bytes(b"torn")
    with pytest.warns(UserWarning, match="skipping corrupt checkpoint step 2"):
        out, manifest = load_checkpoint(tmp_path, t)
    assert manifest["step"] == 1 and manifest["skipped_steps"][0]["step"] == 2
    _assert_same(out, t)
    with pytest.raises(ValueError):
        load_checkpoint(tmp_path, t, fallback=False)


def test_gc_keeps_last_k(tmp_path):
    t = _tree()
    for s in range(6):
        save_checkpoint(tmp_path, s, t, keep=3)
    assert sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*")) == [3, 4, 5]


def test_async_manager(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    mgr.save_async(10, t)
    t["a"] += 1  # the snapshot was taken: the write keeps the step-10 values
    mgr.save_async(20, t)  # waits for 10 first
    mgr.wait()
    assert mgr.latest_step() == 20
    old, _ = load_checkpoint(tmp_path, t, step=10)
    assert torch.equal(old["a"], t["a"] - 1)
    assert mgr.snapshot_s >= 0 and mgr.write_s >= 0


def test_async_save_failure_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path)

    def boom(*a, **k):
        raise OSError("disk on fire")

    monkeypatch.setattr(store, "save_checkpoint", boom)
    mgr.save_async(7, _tree())
    with pytest.raises(AsyncCheckpointError) as ei:
        mgr.wait()
    assert ei.value.step == 7 and isinstance(ei.value.__cause__, OSError)
    mgr.wait()  # surfaced exactly once


def test_async_save_failure_surfaces_on_next_save(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path)
    real = store.save_checkpoint

    def boom(*a, **k):
        raise RuntimeError("transient writer death")

    monkeypatch.setattr(store, "save_checkpoint", boom)
    mgr.save_async(1, _tree())
    monkeypatch.setattr(store, "save_checkpoint", real)
    with pytest.raises(AsyncCheckpointError) as ei:
        mgr.save_async(2, _tree())
    assert ei.value.step == 1
    mgr.save_async(2, _tree())
    mgr.wait()
    assert mgr.latest_step() == 2


def test_elastic_load_on_two_ranks(tmp_path):
    """A whole smoke GLM-4 state saved once, loaded on a (1, 2) mesh: each
    rank's leaves are its slices, equal to ``LM(cfg, mesh)``'s (same seed)."""
    from repro_torch import configs
    from repro_torch.models.lm import LM

    whole = LM(configs.smoke(TR.TRAIN_ARCH), device="cpu", seed=5).state_dict()
    save_checkpoint(tmp_path / "ckpt", 9, {"params": whole})
    TR.start(TR.run_elastic_rank, tmp_path, world=TR.WORLD)(timeout=300)
    for r in range(TR.WORLD):
        res = json.loads((tmp_path / f"elastic{r}.json").read_text())
        assert res["step"] == 9 and all(res["same"].values()), r
        assert res["shapes"]["blocks.0.attn.wq"] == [64, 32]  # a column slice of (64, 64)


def _ref_tree():
    from repro.optim import OptState

    return {"a": jnp.arange(12.0).reshape(3, 4),
            "nested": {"b": jnp.full((5,), 1.5, jnp.bfloat16), "c": jnp.int32(7)},
            "opt": OptState(jnp.int32(3), {"w": jnp.full((2, 2), -0.25)},
                            {"w": jnp.full((2, 2), 2.0)})}


def _port_like_ref():
    from repro_torch.optim import OptState

    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.full((5,), 1.5, dtype=torch.bfloat16),
                       "c": torch.tensor(7, dtype=torch.int32)},
            "opt": OptState(torch.tensor(3, dtype=torch.int32), {"w": torch.full((2, 2), -0.25)},
                            {"w": torch.full((2, 2), 2.0)})}


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    from repro.checkpoint import save_checkpoint as ref_save

    ref_save(tmp_path, 4, _ref_tree())
    out, manifest = load_checkpoint(tmp_path, _port_like_ref())
    assert manifest["step"] == 4
    _assert_same(out, _port_like_ref())


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    from repro.checkpoint import load_checkpoint as ref_load

    save_checkpoint(tmp_path, 5, _port_like_ref())
    out, manifest = ref_load(tmp_path, _ref_tree())
    assert manifest["step"] == 5
    want = jax.tree_util.tree_leaves_with_path(_ref_tree())
    got = jax.tree_util.tree_leaves(out)
    for (path, w), g in zip(want, got):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), path
