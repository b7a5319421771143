"""Checkpointing + transfer learning + self-contained export.

Covers the reference's three persistence mechanisms (SURVEY.md §5):
1. periodic best-checkpoint save (Keras ModelCheckpoint, source/main.py:137-142)
   -> :func:`save_checkpoint` with step-named subdirs;
2. best-model serving export (BestModelSaverCallback, training_utils.py:62-74)
   -> :func:`export_serving` bundles params + ModelConfig JSON + vocab
   artifacts, preserving the reference's "self-contained SavedModel" property
   without string ops in the graph;
3. warm-start / fine-tune (create_model(ckpt_dir), source/main.py:100-120)
   -> :func:`restore_params` (full) and :func:`restore_encoder` (encoder +
   embeddings only, new head — the transfer-learning path promised in the
   reference README.md:26-27).

On-disk format: a directory holding ``arrays.npz`` (one entry per pytree
leaf, in flatten order) and ``manifest.json`` (each leaf's tree path, dtype
and shape). It is written into a hidden temporary sibling and renamed into
place, so a directory named ``step_<N>`` is always a complete checkpoint.
Restores look leaves up by tree path, so a subtree (the encoder for
transfer learning) restores from a fuller checkpoint.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import jax
import numpy as np

from bert4clickpath.config import ModelConfig

_ARRAYS = "arrays.npz"
_MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"step_(\d+)")


def _to_storable(leaf) -> tuple[np.ndarray, str]:
    """numpy has no bfloat16 (and other ML dtypes) in .npz: store those as
    same-width unsigned ints and record the real dtype in the manifest."""
    arr = np.asarray(leaf)
    name = arr.dtype.name
    if arr.dtype.kind == "V" or name not in np.sctypeDict:
        arr = arr.view(f"u{arr.dtype.itemsize}")
    return arr, name


def _write_tree(path: str, tree: Any) -> None:
    """Write ``tree`` to ``path`` atomically (tmp sibling + rename)."""
    path = os.path.abspath(path)
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{name}.tmp-{os.getpid()}-{threading.get_ident()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    arrays, entries = {}, []
    for i, (kp, leaf) in enumerate(leaves):
        arr, dtype = _to_storable(leaf)
        arrays[f"a{i}"] = arr
        entries.append(
            {"path": jax.tree_util.keystr(kp), "dtype": dtype, "shape": list(np.shape(leaf))}
        )
    try:
        with open(os.path.join(tmp, _ARRAYS), "wb") as f:
            np.savez(f, **arrays)
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump({"format": 1, "leaves": entries}, f)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(path):
        # replacing (force): move the old copy aside first so ``path`` is
        # either the old or the new complete tree, never a partial one
        old = tmp + ".old"
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, path)


def _read_tree(path: str, abstract: Any) -> Any:
    """Leaves of ``abstract`` (any pytree of arrays / ShapeDtypeStructs)
    filled from the checkpoint at ``path`` by tree path."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _MANIFEST)) as f:
        entries = json.load(f)["leaves"]
    index = {e["path"]: (i, e) for i, e in enumerate(entries)}
    leaves, treedef = jax.tree_util.tree_flatten_with_path(abstract)
    out = []
    with np.load(os.path.join(path, _ARRAYS)) as data:
        for kp, like in leaves:
            key = jax.tree_util.keystr(kp)
            if key not in index:
                raise KeyError(f"checkpoint {path} has no leaf {key}")
            i, e = index[key]
            arr = data[f"a{i}"]
            if arr.dtype.name != e["dtype"]:
                arr = arr.view(np.dtype(jax.numpy.dtype(e["dtype"])))
            if tuple(arr.shape) != tuple(np.shape(like)):
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != expected {np.shape(like)}"
                )
            out.append(arr.astype(like.dtype, copy=False))
    return jax.tree_util.tree_unflatten(treedef, [leaf for leaf in out])


class _AsyncWriter:
    """At most one checkpoint write in flight, on one background thread."""

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="checkpoint"
        )
        self._pending: Optional[concurrent.futures.Future] = None

    def wait(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()  # re-raises a failed write

    def submit(self, fn, *args) -> None:
        self.wait()
        self._pending = self._pool.submit(fn, *args)


_WRITER = _AsyncWriter()


def _save_and_prune(path: str, tree: Any, directory: str, keep: Optional[int]) -> None:
    _write_tree(path, tree)
    if keep:
        # after the commit: with keep=1 a crash mid-save still leaves the
        # previous checkpoint in place
        prune_checkpoints(directory, keep)


def save_checkpoint(
    directory: str, state: Any, step: int, block: bool = True,
    keep: Optional[int] = None,
) -> str:
    """Save a full TrainState under ``directory/step_<N>``.

    ``block=False`` returns once the state is copied to host memory and
    overlaps the disk write with the next training epoch; a later save (or
    :func:`wait_until_finished`) waits for it. ``block=True`` returns after
    the atomic rename.

    keep: retain at most this many checkpoints in ``directory`` INCLUDING
    the one being saved (None/0 = keep everything — the reference's
    timestamped ``ModelCheckpoint`` accumulation, source/main.py:137-142,
    which ran to ~10 GB per Beauty run). Pruning runs only after the new
    checkpoint has been committed.
    """
    directory = os.path.abspath(directory)
    path = os.path.join(directory, f"step_{step:08d}")
    host = jax.tree.map(np.asarray, jax.device_get(state))
    _WRITER.submit(_save_and_prune, path, host, directory, keep)
    if block:
        _WRITER.wait()
    return path


def prune_checkpoints(directory: str, keep: int) -> list[str]:
    """Delete the oldest committed ``step_*`` checkpoints, keeping the
    newest ``keep``. Writes go to hidden temporary siblings and are renamed
    on commit, so the ``step_<N>`` fullmatch only ever selects committed
    checkpoints. Returns the removed paths."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return []
    steps = sorted(
        (int(m.group(1)), name)
        for name in os.listdir(directory)
        if (m := _STEP_RE.fullmatch(name))
    )
    removed = []
    for _, name in steps[: max(len(steps) - keep, 0)]:
        p = os.path.join(directory, name)
        shutil.rmtree(p, ignore_errors=True)
        removed.append(p)
    return removed


def wait_until_finished() -> None:
    _WRITER.wait()


def latest_checkpoint(directory: str) -> Optional[str]:
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = [
        (int(m.group(1)), name)
        for name in os.listdir(directory)
        if (m := _STEP_RE.fullmatch(name))
    ]
    if not steps:
        return None
    return os.path.join(directory, max(steps)[1])


def restore_state(path: str, abstract_state: Any) -> Any:
    """Restore a TrainState saved by :func:`save_checkpoint`.

    ``abstract_state`` is a matching pytree (e.g. a freshly created state or
    ``jax.eval_shape`` output) providing structure/shapes/dtypes. Leaves come
    back as host numpy arrays.
    """
    return _read_tree(path, abstract_state)


def save_params(path: str, params: Any) -> None:
    _WRITER.wait()
    _write_tree(path, jax.tree.map(np.asarray, jax.device_get(params)))


def restore_params(path: str, abstract_params: Any) -> Any:
    return _read_tree(path, abstract_params)


def restore_encoder(path: str, init_params: Any) -> Any:
    """Transfer learning: load encoder + embedding subtrees from ``path``,
    keep everything else (the new head) freshly initialized.

    Matches the reference contract that the pretrained encoder + embeddings
    can be reused under a different head (source/main.py:100-120; named
    embedding layer, constants.py:35-39).
    """
    restored = restore_params(path, init_params_like_subset(init_params))
    out = jax.tree.map(lambda x: x, init_params)  # copy
    for key, sub in restored["params"].items():
        out["params"][key] = sub
    return out


def init_params_like_subset(init_params: Any) -> Any:
    """The encoder/embedding subset of a param tree (what transfer restores)."""
    subset = {"params": {}}
    for key, sub in init_params["params"].items():
        if key == "encoder" or key.startswith("embed_") or key == "positions":
            subset["params"][key] = sub
    return subset


# -- self-contained serving export ---------------------------------------


def export_serving(
    directory: str,
    params: Any,
    model_config: ModelConfig,
    vocabs: dict[str, Any],
) -> str:
    """Bundle everything needed to serve from strings: params + config +
    vocab artifacts — the equivalent of the reference's SavedModel with
    baked-in lookup tables (clickstream_transformer.py:354-375)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "model_config.json"), "w") as f:
        f.write(model_config.to_json())
    for name, vocab in vocabs.items():
        vocab.save_artifact(directory, name)
    save_params(os.path.join(directory, "params"), params)
    with open(os.path.join(directory, "MANIFEST.json"), "w") as f:
        json.dump({"vocabs": sorted(vocabs), "format": 1}, f)
    return directory
