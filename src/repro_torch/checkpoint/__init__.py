"""Sharded, atomic checkpointing in the JAX package's on-disk format (port
of ``repro.checkpoint``).

Layout, file for file the JAX package's::

    <dir>/step_<n>/
        manifest.msgpack     # treedef, n_leaves, extra, shards, dtypes
        shard_<i>.npz        # leaf arrays leaf_<i> (host copies)
        .complete            # written last — presence marks a valid ckpt

so a snapshot either package writes restores in the other: the manifest
goes through :mod:`._msgpack` (byte-identical to ``msgpack.packb``),
trees flatten in ``jax.tree.flatten``'s order (dict keys sorted, so a
lifecycle tree is ``[cursor, ta]``) and ``treedef`` is the string JAX
prints (``PyTreeDef({'cursor': *, 'ta': *})``).

- atomic: written to ``<dir>/.tmp_step_<n>``, then renamed; a crash
  leaves no half-checkpoint that restore could pick up;
- async: ``save_async`` copies every leaf to the host first, then
  serializes on a writer thread;
- retention: ``gc_keep`` prunes old steps, never one that a writer has
  registered in flight (registered before the writer thread starts);
- lifecycle adapters: :func:`tm_lifecycle_tree` shapes a TM server
  snapshot (TA state as ``int32`` plus the update-key-chain cursor as
  ``uint32``) and :func:`restore_tm_lifecycle` rebuilds it.

Leaves are torch tensors (any device) or numpy arrays; :func:`restore`
returns numpy arrays, as the JAX ``restore`` does without
``shardings``.  Not ported (see ROADMAP.md): ``shardings=`` (the
multi-GPU slice, queue 1 item 6) and dtypes numpy cannot name, such as
``bfloat16`` (the LM zoo, queue 1 item 7); both raise
``NotImplementedError``.
"""

from __future__ import annotations

import os
import shutil
import threading
import time

import numpy as np
import torch

from ._msgpack import packb, unpackb

__all__ = ["save", "save_async", "restore", "latest_step", "valid_steps",
           "gc_keep", "read_manifest_extra", "tm_lifecycle_tree",
           "restore_tm_lifecycle", "wait_for_complete"]

_MAX_SHARD_BYTES = 1 << 30

# steps currently being written, per directory: (abspath, step) → count.
# save/save_async register here so gc_keep never prunes a step whose
# ``.complete`` marker hasn't landed yet (a re-save of an old step number
# after a rollback would otherwise race retention's rmtree)
_inflight_lock = threading.Lock()
_inflight: dict[tuple[str, int], int] = {}


def _inflight_key(directory: str, step: int) -> tuple[str, int]:
    return os.path.abspath(directory), step


def _inflight_add(directory: str, step: int) -> None:
    key = _inflight_key(directory, step)
    with _inflight_lock:
        _inflight[key] = _inflight.get(key, 0) + 1


def _inflight_remove(directory: str, step: int) -> None:
    key = _inflight_key(directory, step)
    with _inflight_lock:
        n = _inflight.get(key, 0) - 1
        if n <= 0:
            _inflight.pop(key, None)
        else:
            _inflight[key] = n


def _inflight_steps(directory: str) -> set[int]:
    prefix = os.path.abspath(directory)
    with _inflight_lock:
        return {step for (d, step) in _inflight if d == prefix}


# -- trees: jax.tree.flatten's order and treedef string -----------------


def _flatten(tree, leaves: list) -> str:
    """Append ``tree``'s leaves in ``jax.tree.flatten`` order → the
    structure as JAX prints it inside ``PyTreeDef(...)``.  Nodes are
    dicts (keys sorted), lists, tuples and ``None``; leaves are tensors,
    numpy arrays and Python or numpy scalars."""
    if tree is None:
        return "None"
    if type(tree) is dict:
        keys = sorted(tree)
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in keys) + "}"
    if type(tree) is list:
        return "[" + ", ".join(_flatten(x, leaves) for x in tree) + "]"
    if type(tree) is tuple:
        inner = [_flatten(x, leaves) for x in tree]
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic, int, float)):
        leaves.append(tree)
        return "*"
    raise TypeError(f"checkpoint trees hold dicts, lists, tuples, None "
                    f"and array leaves, not {type(tree).__name__}")


def _tree_flatten(tree) -> tuple[list, str]:
    leaves: list = []
    return leaves, f"PyTreeDef({_flatten(tree, leaves)})"


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from an iterator of leaves."""
    if like is None:
        return None
    if type(like) is dict:
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if type(like) in (list, tuple):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    """One leaf as a host numpy array; a tensor is always copied (off its
    device, or in host memory), so the caller may go on mutating it."""
    if isinstance(leaf, torch.Tensor):
        try:
            return leaf.detach().to("cpu", copy=True).numpy()
        except TypeError as exc:       # bfloat16 and other non-numpy types
            raise NotImplementedError(
                f"a {leaf.dtype} leaf has no numpy dtype; checkpoints of "
                f"such leaves come with the LM zoo (ROADMAP.md, queue 1 "
                f"item 7)") from exc
    return np.asarray(leaf)


def _host_tree(tree):
    leaves, _ = _tree_flatten(tree)
    return _unflatten(tree, iter([_host(x) for x in leaves]))


# -- save / restore -----------------------------------------------------


def save(directory: str, step: int, tree, *, extra: dict | None = None):
    """Blocking save. ``tree`` may hold torch tensors or numpy arrays."""
    _inflight_add(directory, step)
    try:
        _save_unguarded(directory, step, _host_tree(tree), extra=extra)
    finally:
        _inflight_remove(directory, step)


def _save_unguarded(directory: str, step: int, tree, *,
                    extra: dict | None = None):
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves, treedef = _tree_flatten(tree)
    manifest = {"treedef": treedef, "n_leaves": len(leaves),
                "extra": extra or {}, "shards": [], "dtypes": []}
    shard: dict[str, np.ndarray] = {}
    shard_bytes, shard_idx = 0, 0

    def flush():
        nonlocal shard, shard_bytes, shard_idx
        if not shard:
            return
        fn = f"shard_{shard_idx}.npz"
        np.savez(os.path.join(tmp, fn), **shard)
        manifest["shards"].append({"file": fn, "keys": sorted(shard)})
        shard, shard_bytes, shard_idx = {}, 0, shard_idx + 1

    for i, leaf in enumerate(leaves):
        arr = np.asarray(leaf)
        manifest["dtypes"].append(str(arr.dtype))
        if arr.dtype.kind == "V":        # bfloat16 etc: npz-safe raw view
            arr = arr.view(np.uint8)
        shard[f"leaf_{i}"] = arr
        shard_bytes += arr.nbytes
        if shard_bytes >= _MAX_SHARD_BYTES:
            flush()
    flush()

    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))
    with open(os.path.join(tmp, ".complete"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def save_async(directory: str, step: int, tree, *, extra: dict | None = None
               ) -> threading.Thread:
    """Fire-and-forget save off the critical path: every leaf is copied
    to the host up front (the caller may go on mutating its tensors),
    then a writer thread serializes.

    The step is registered in flight *before* the writer thread starts,
    so a ``gc_keep`` issued the moment this returns can never prune it."""
    host_tree = _host_tree(tree)
    _inflight_add(directory, step)

    def write():
        try:
            _save_unguarded(directory, step, host_tree, extra=extra)
        finally:
            _inflight_remove(directory, step)

    t = threading.Thread(target=write, daemon=True,
                         name=f"ckpt-save-{step}")
    t.start()
    return t


def latest_step(directory: str) -> int | None:
    """Newest step number with a valid (``.complete``) checkpoint, or
    ``None`` when the directory holds none."""
    steps = valid_steps(directory)
    return steps[-1] if steps else None


def valid_steps(directory: str) -> list[int]:
    """Ascending step numbers of every valid (``.complete``) checkpoint."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name.split("_")[1]) for name in os.listdir(directory)
        if name.startswith("step_")
        and os.path.exists(os.path.join(directory, name, ".complete")))


def _read_manifest(directory: str, step: int) -> dict:
    path = os.path.join(directory, f"step_{step}", "manifest.msgpack")
    with open(path, "rb") as f:
        return unpackb(f.read())


def _shardings_unported(shardings) -> None:
    if shardings is not None:
        raise NotImplementedError(
            "shardings=: restoring onto several GPUs comes with the "
            "multi-GPU slice (ROADMAP.md, queue 1 item 6)")


def restore(directory: str, step: int, like, *, shardings=None):
    """Restore into the structure of ``like`` → ``(tree, extra)`` with
    numpy leaves in their saved dtypes.  ``shardings`` must be ``None``
    (see the module docstring)."""
    _shardings_unported(shardings)
    path = os.path.join(directory, f"step_{step}")
    manifest = _read_manifest(directory, step)
    data = {}
    for sh in manifest["shards"]:
        with np.load(os.path.join(path, sh["file"])) as z:
            for k in sh["keys"]:
                data[k] = z[k]
    leaves_like, _ = _tree_flatten(like)
    if len(leaves_like) != manifest["n_leaves"]:
        raise ValueError(f"step_{step} holds {manifest['n_leaves']} leaves, "
                         f"the restore structure {len(leaves_like)}")
    dtypes = manifest.get("dtypes", [None] * len(leaves_like))
    out = []
    for i in range(len(leaves_like)):
        arr = data[f"leaf_{i}"]
        want = dtypes[i]
        if want and str(arr.dtype) != want:
            # a raw-byte leaf (bfloat16 and other extension dtypes, which
            # plain numpy cannot name): the JAX package views it back
            # through ml_dtypes
            raise NotImplementedError(
                f"leaf_{i} of step_{step} is {want}, stored as raw "
                f"{arr.dtype}; such leaves come with the LM zoo "
                f"(ROADMAP.md, queue 1 item 7)")
        out.append(arr)
    return _unflatten(like, iter(out)), manifest.get("extra", {})


def gc_keep(directory: str, keep: int = 3):
    """Prune old checkpoints, keeping the newest ``keep`` valid steps.

    A step registered in flight is never pruned, even when a stale
    *completed* directory of the same number exists (the re-save after a
    rollback): pruning it would race the writer's final rename.  It
    becomes an ordinary candidate once its writer finishes.
    """
    if not os.path.isdir(directory):
        return
    pinned = _inflight_steps(directory)
    steps = valid_steps(directory)
    for s in steps[:-keep] if keep > 0 else steps:
        if s in pinned:
            continue
        shutil.rmtree(os.path.join(directory, f"step_{s}"))


# -- TM server lifecycle adapters -----------------------------------------


def read_manifest_extra(directory: str, step: int) -> dict:
    """The ``extra`` metadata dict of one saved step (no shard load)."""
    return _read_manifest(directory, step).get("extra", {})


def tm_lifecycle_tree(ta, cursor=None) -> dict:
    """The save tree for one TM server lifecycle snapshot.

    ``ta``: the ``(C, M, 2F)`` TA states (tensor or array), written as
    ``int32``.  ``cursor``: the update-key-chain cursor — the port's
    int32 key words, or raw ``uint32`` key data
    (:func:`repro_torch.engine.export_key_cursor`) — written as
    ``uint32`` by reinterpreting the same bits, or ``None`` for an
    inference-only snapshot.  The manifest's ``extra`` must record
    ``has_cursor``.
    """
    tree = {"ta": _host(ta).astype(np.int32, copy=False)}
    if cursor is not None:
        words = _host(cursor)
        if words.dtype == np.int32:
            words = words.view(np.uint32)
        if words.dtype != np.uint32:
            raise TypeError(f"a key cursor holds 32-bit words, got "
                            f"{words.dtype}")
        tree["cursor"] = words
    return tree


def restore_tm_lifecycle(directory: str, step: int | None = None, *,
                         shardings: dict | None = None
                         ) -> tuple[int, dict, dict]:
    """Load one lifecycle snapshot → ``(step, tree, extra)``.

    ``step=None`` picks the newest valid step.  ``tree`` matches
    :func:`tm_lifecycle_tree` (``cursor`` present iff the snapshot
    recorded one), numpy leaves.  Raises ``FileNotFoundError`` when the
    directory holds no valid checkpoint."""
    _shardings_unported(shardings)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no valid checkpoint (step_*/.complete) under {directory}")
    extra = read_manifest_extra(directory, step)
    like = tm_lifecycle_tree(np.zeros((), np.int32),
                             np.zeros((), np.uint32)
                             if extra.get("has_cursor") else None)
    tree, extra = restore(directory, step, like)
    return step, tree, extra


def wait_for_complete(directory: str, step: int | None = None, *,
                      timeout: float = 30.0, poll: float = 0.05) -> int:
    """Block until a valid checkpoint exists → its step number.

    The follower half of the leader-writes/followers-read discipline:
    saves are atomic, so a follower polls until a ``.complete`` marker
    lands instead of reading a torn snapshot.  ``step=None`` waits for
    any valid step (→ the newest).  Raises ``TimeoutError`` after
    ``timeout`` seconds.
    """
    deadline = time.monotonic() + timeout
    while True:
        steps = valid_steps(directory)
        if step is None and steps:
            return steps[-1]
        if step is not None and step in steps:
            return step
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"no valid checkpoint{'' if step is None else f' step_{step}'}"
                f" under {directory} after {timeout}s")
        time.sleep(poll)
