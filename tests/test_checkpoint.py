"""training/checkpoint: the npz + manifest writer — round trip, atomic
commit, pruning only after a commit, one async save in flight."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bert4clickpath.training import checkpoint as ckpt


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": jnp.asarray(rng.normal(size=(5, 3)), jnp.float32),
            "b16": jnp.asarray(rng.normal(size=(4,)), jnp.bfloat16),
        },
        "step": jnp.asarray(7, jnp.int32),
        "mu": [jnp.asarray(rng.normal(size=(2, 2)), jnp.float32)],
    }


def _assert_tree_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_round_trip_keeps_values_and_dtypes(tmp_path):
    tree = _tree()
    path = ckpt.save_checkpoint(str(tmp_path), tree, 3)
    assert os.path.basename(path) == "step_00000003"
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    _assert_tree_equal(ckpt.restore_state(path, _tree(seed=1)), tree)
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert {e["path"]: e["dtype"] for e in leaves}["['params']['b16']"] == "bfloat16"


def test_subtree_restores_by_path_and_mismatches_raise(tmp_path):
    tree = _tree()
    path = ckpt.save_checkpoint(str(tmp_path), tree, 1)
    sub = ckpt.restore_params(path, {"params": {"w": jnp.zeros((5, 3))}})
    np.testing.assert_array_equal(sub["params"]["w"], np.asarray(tree["params"]["w"]))
    with pytest.raises(KeyError, match="no leaf"):
        ckpt.restore_params(path, {"params": {"missing": jnp.zeros((5, 3))}})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_params(path, {"params": {"w": jnp.zeros((3, 5))}})


def _disk_full(*args, **kwargs):
    raise OSError("disk full")


def test_failed_write_commits_nothing(tmp_path, monkeypatch):
    """A write that dies before its rename leaves no ``step_`` directory:
    the latest checkpoint is still the previous one, whole."""
    tree = _tree()
    first = ckpt.save_checkpoint(str(tmp_path), tree, 1)
    monkeypatch.setattr(np, "savez", _disk_full)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(str(tmp_path), _tree(seed=2), 2)
    assert ckpt.latest_checkpoint(str(tmp_path)) == first
    assert not (tmp_path / "step_00000002").exists()
    _assert_tree_equal(ckpt.restore_state(first, tree), tree)


def test_prune_runs_only_after_the_new_commit(tmp_path, monkeypatch):
    """keep=1: a save that fails mid-write must not have pruned the only
    good checkpoint; a save that commits prunes the older ones."""
    ckpt.save_checkpoint(str(tmp_path), _tree(), 1, keep=1)
    with monkeypatch.context() as m:
        m.setattr(np, "savez", _disk_full)
        with pytest.raises(OSError):
            ckpt.save_checkpoint(str(tmp_path), _tree(seed=1), 2, keep=1)
    assert os.listdir(tmp_path) == ["step_00000001"]  # no partial write left
    path = ckpt.save_checkpoint(str(tmp_path), _tree(seed=3), 3, keep=1)
    assert [n for n in os.listdir(tmp_path) if n.startswith("step_")] == ["step_00000003"]
    _assert_tree_equal(ckpt.restore_state(path, _tree()), _tree(seed=3))


def test_async_saves_one_in_flight(tmp_path):
    """block=False returns before the write; the next save waits for it, so
    every requested checkpoint commits, in order."""
    for step in (1, 2, 3):
        ckpt.save_checkpoint(str(tmp_path), _tree(seed=step), step, block=False, keep=2)
    ckpt.wait_until_finished()
    assert sorted(n for n in os.listdir(tmp_path) if n.startswith("step_")) == [
        "step_00000002", "step_00000003"
    ]
    _assert_tree_equal(
        ckpt.restore_state(ckpt.latest_checkpoint(str(tmp_path)), _tree()), _tree(seed=3)
    )


def test_overwrite_replaces_whole_tree(tmp_path):
    """save_params over an existing export swaps the directory whole."""
    path = str(tmp_path / "export" / "params")
    ckpt.save_params(path, _tree(seed=1))
    ckpt.save_params(path, _tree(seed=2))
    _assert_tree_equal(ckpt.restore_params(path, _tree()), _tree(seed=2))
    assert sorted(os.listdir(tmp_path / "export")) == ["params"]
