"""Sharded, atomic checkpointing in the JAX package's on-disk format (port
of ``repro.checkpoint``).

Layout, file for file the JAX package's::

    <dir>/step_<n>/
        manifest.msgpack     # treedef, n_leaves, extra, shards, dtypes
        shard_<i>.npz        # leaf arrays leaf_<i> (host copies)
        .complete            # written last — presence marks a valid ckpt

so a snapshot either package writes restores in the other: the manifest
goes through :mod:`._msgpack` (byte-identical to ``msgpack.packb``),
trees flatten in ``jax.tree.flatten``'s order (:mod:`repro_torch.tree`:
dict keys sorted, so a lifecycle tree is ``[cursor, ta]``; a NamedTuple
such as a ``TrainState`` in field order) and ``treedef`` is the string
JAX prints (``PyTreeDef({'cursor': *, 'ta': *})``,
``CustomNode(namedtuple[TrainState], [...])``).

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
``shardings``.  A ``bfloat16`` leaf, which numpy cannot name, is stored
as the JAX package stores it: manifest dtype ``"bfloat16"``, its bytes
as ``uint8`` (the last axis twice as long); it is read back as a
``torch.bfloat16`` tensor on the CPU (no ``ml_dtypes``).  With
``shardings=`` — a tree with the restored tree as its prefix whose
leaves are ``torch.device`` objects or ``None`` — every loaded leaf
becomes a tensor on its device (``None``: on the CPU), the counterpart
of the JAX package's ``device_put`` under the restoring mesh's
shardings.  Snapshots are host copies, so a checkpoint written on one
mesh restores onto any other.
"""

from __future__ import annotations

import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch import tree as _tree
from repro_torch.distributed.sharding import NamedSharding, ShardedTensor

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


class _RawLeaf:
    """The host copy of a ``bfloat16`` tensor: its bytes as ``uint8``
    (``view(torch.uint8)``: the last axis twice as long), the form the
    JAX package writes for a dtype numpy cannot name."""

    __slots__ = ("dtype", "raw")

    def __init__(self, dtype: str, raw: np.ndarray):
        self.dtype, self.raw = dtype, raw


_LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, int, float, _RawLeaf,
               ShardedTensor)


def _tree_flatten(tree) -> tuple[list, str]:
    """``tree``'s leaves in ``jax.tree.flatten`` order and the structure
    as JAX prints it; every leaf must be an array, a tensor or a
    number."""
    leaves, treedef = _tree.flatten(tree)
    for leaf in leaves:
        if not isinstance(leaf, _LEAF_TYPES):
            raise TypeError(f"checkpoint trees hold dicts, lists, tuples, "
                            f"NamedTuples, None and array leaves, not "
                            f"{type(leaf).__name__}")
    return leaves, treedef


def _host(leaf):
    """One leaf as a host numpy array (a ``bfloat16`` tensor as a
    :class:`_RawLeaf`); a tensor is always copied (off its device, or in
    host memory), so the caller may go on mutating it.  A sharded leaf
    is gathered: the file holds the global array, as without a mesh."""
    if isinstance(leaf, ShardedTensor):
        leaf = leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return _RawLeaf("bfloat16", t.view(torch.uint8).numpy())
        return t.numpy()
    return np.asarray(leaf)


def _host_tree(tree):
    leaves, _ = _tree_flatten(tree)
    return _tree.unflatten(tree, iter([_host(x) for x in leaves]))


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
        if isinstance(leaf, _RawLeaf):
            manifest["dtypes"].append(leaf.dtype)
            arr = leaf.raw
        else:
            arr = np.asarray(leaf)
            manifest["dtypes"].append(str(arr.dtype))
            if arr.dtype.kind == "V":    # bfloat16 etc: npz-safe raw view
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


def _place(tree, shardings):
    """Move every leaf of ``tree`` (numpy, or a bfloat16 tensor) to the
    device ``shardings`` names for it (a tree with ``tree`` as its
    prefix: a device or ``None`` covers the whole subtree where it
    stands; a :class:`NamedSharding` slices its leaf into a
    :class:`ShardedTensor` over its mesh) → tensors."""
    if isinstance(shardings, NamedSharding):
        return ShardedTensor.from_full(
            tree if isinstance(tree, torch.Tensor) else torch.from_numpy(tree),
            shardings)
    if shardings is None or isinstance(shardings, torch.device):
        def put(x):
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
            return t if shardings is None else t.to(shardings)
        return _tree.map(put, tree)
    if type(tree) is dict and type(shardings) is dict \
            and set(tree) == set(shardings):
        return {k: _place(tree[k], shardings[k]) for k in tree}
    if (type(tree) is list or isinstance(tree, tuple)) \
            and type(shardings) is type(tree) and len(tree) == len(shardings):
        return _tree.rebuild(tree, [_place(x, s)
                                     for x, s in zip(tree, shardings)])
    raise ValueError(f"shardings {shardings!r} do not match the restored "
                     f"tree's structure")


def _read_leaf(arr: np.ndarray, want: str | None, name: str):
    """One stored leaf in its saved dtype: a raw-byte ``bfloat16`` leaf
    becomes a ``torch.bfloat16`` tensor (numpy has no such dtype)."""
    if not want or str(arr.dtype) == want:
        return arr
    if want == "bfloat16" and arr.dtype == np.uint8:
        return torch.from_numpy(arr).view(torch.bfloat16)
    raise TypeError(f"{name} is {want}, stored as raw {arr.dtype}; the "
                    f"port reads raw-byte leaves of bfloat16 only")


def restore(directory: str, step: int, like, *, shardings=None):
    """Restore into the structure of ``like`` → ``(tree, extra)`` with
    numpy leaves in their saved dtypes (``bfloat16`` ones as CPU
    tensors), or, with ``shardings``, tensors on the devices it names
    (see the module docstring)."""
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
    out = [_read_leaf(data[f"leaf_{i}"], dtypes[i], f"leaf_{i} of step_{step}")
           for i in range(len(leaves_like))]
    tree = _tree.unflatten(like, iter(out))
    if shardings is not None:
        tree = _place(tree, shardings)
    return tree, manifest.get("extra", {})


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
    recorded one), numpy leaves.  ``shardings=`` is a (possibly partial)
    dict of ``torch.device`` objects by leaf name, forwarded to
    :func:`restore`: the elastic seam, where a snapshot written on one
    mesh lands on another's devices.  Raises ``FileNotFoundError`` when
    the directory holds no valid checkpoint."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no valid checkpoint (step_*/.complete) under {directory}")
    extra = read_manifest_extra(directory, step)
    like = tm_lifecycle_tree(np.zeros((), np.int32),
                             np.zeros((), np.uint32)
                             if extra.get("has_cursor") else None)
    sh = {k: shardings.get(k) for k in like} if shardings else None
    tree, extra = restore(directory, step, like, shardings=sh)
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
