"""Fault-tolerant checkpointing: atomic tmp-then-rename step directories,
``keep=N`` rotation, optional async writes, and a JSON manifest carrying
(step, extras) so kill/resume is bitwise-deterministic.

Layout (one directory per step, the rename is the commit point):

    <dir>/step_00000042/
        manifest.json     step, extras, per-leaf dtype/shape table
        arrays.npz        leaves in template flatten order (arrays only —
                          object leaves are rejected before any I/O)

A crashed writer leaves only a ``.tmp-*`` directory behind, which readers
ignore — ``latest_step`` can never observe a partial checkpoint
(tests/test_checkpoint.py::test_atomic_write_never_partial).

Port of ``repro/dist/checkpoint.py``, in the same on-disk format, so a
checkpoint written by either package restores in the other.  A checkpoint
holds a tree of tensors: dicts (flattened in sorted key order, as JAX
flattens them), lists and tuples, and ``TreeArrays`` (its 16 array fields
in ``ARRAY_FIELDS`` order, the reference's ``data_fields``).  Restore takes
a *template* of the same structure and puts every leaf on the device of
the template's leaf; there is no sharding argument.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.smtree import ARRAY_FIELDS, TreeArrays

_STEP_PREFIX = "step_"
_TMP_PREFIX = ".tmp-"
_ARRAYS = "arrays.npz"
_MANIFEST = "manifest.json"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"{_STEP_PREFIX}{step:08d}")


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}"


def _leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's flatten order: dict values by sorted
    key, list and tuple items in order, a ``TreeArrays``' 16 array fields
    in ``ARRAY_FIELDS`` order; ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, TreeArrays):
        return [getattr(tree, f) for f in ARRAY_FIELDS]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in _leaves(sub)]
    return [tree]


def _unflatten(template, leaves):
    """``template`` with its leaves replaced, in ``_leaves`` order, by the
    items of the iterator ``leaves``."""
    if template is None:
        return None
    if isinstance(template, TreeArrays):
        return dataclasses.replace(
            template, **{f: next(leaves) for f in ARRAY_FIELDS})
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(x, leaves) for x in template)
    return next(leaves)


def _to_host(tree) -> list[tuple[np.ndarray, str]]:
    """Fetch every leaf to host memory synchronously, as (array to store,
    dtype name) pairs: a bf16 tensor is stored as its uint16 bits under the
    name ``bfloat16`` (npz has no bf16).

    Must happen before any deferred write: the caller may write these
    tensors in place right after ``save`` returns.  Non-array leaves
    become object arrays, rejected here so atomicity never depends on how
    far a partial write got."""
    host = []
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            if t.dtype == torch.bfloat16:
                host.append((t.view(torch.int16).numpy().view(np.uint16),
                             "bfloat16"))
                continue
            arr = t.numpy()
        else:
            arr = np.asarray(leaf)
        if arr.dtype == object:
            raise TypeError(f"checkpoint leaf is not an array: {leaf!r}")
        host.append((arr, str(arr.dtype)))
    return host


def fsync_directory(path: str) -> None:
    """fsync a directory fd so a just-committed rename survives power loss.

    The tmp-then-rename commit is atomic per POSIX, but the *directory
    entry* for the renamed name only becomes durable once the parent
    directory is synced (DESIGN.md §9).  Windows has no directory fds;
    there the call is a no-op."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return   # platform without directory fds
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(directory: str, step: int, host: list[tuple[np.ndarray, str]],
           extra: dict | None, fsync_dir: bool = False) -> None:
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = os.path.join(directory,
                       f"{_TMP_PREFIX}{_STEP_PREFIX}{step:08d}.{os.getpid()}")
    try:
        os.makedirs(tmp, exist_ok=True)
        payload = {}
        dtypes = []
        for i, (arr, dtype) in enumerate(host):
            dtypes.append({"dtype": dtype, "shape": list(arr.shape)})
            payload[_leaf_name(i)] = arr
        # object leaves were already rejected in _to_host, so nothing here
        # can pickle; restore additionally loads with allow_pickle=False
        np.savez(os.path.join(tmp, _ARRAYS), **payload)
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump({"step": step, "extra": extra or {},
                       "n_leaves": len(host), "leaves": dtypes}, f)
            if fsync_dir:
                f.flush()
                os.fsync(f.fileno())
        if fsync_dir:
            # file contents must hit disk before the rename that publishes
            # them, else the commit point can expose empty files after a crash
            with open(os.path.join(tmp, _ARRAYS), "rb") as f:
                os.fsync(f.fileno())
            fsync_directory(tmp)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic commit
        if fsync_dir:
            fsync_directory(directory)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


def save_checkpoint(directory: str, step: int, tree,
                    extra: dict | None = None, *,
                    fsync_dir: bool = False) -> str:
    """Write ``tree`` as checkpoint ``step``; returns the committed path.

    ``fsync_dir`` adds the directory fsync after the rename commit
    (durability across power loss, at a measurable latency cost — see the
    ``ckpt_fsync_dir_ms`` row in benchmarks/BENCH_PR3.json)."""
    _write(directory, step, _to_host(tree), extra, fsync_dir)
    return _step_dir(directory, step)


def _complete_steps(directory: str) -> list[int]:
    if not directory or not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if not name.startswith(_STEP_PREFIX):
            continue
        path = os.path.join(directory, name)
        if not os.path.exists(os.path.join(path, _MANIFEST)):
            continue
        try:
            steps.append(int(name.split("_", 1)[1]))
        except ValueError:
            continue
    return sorted(steps)


def latest_step(directory: str) -> int | None:
    """Highest committed checkpoint step, or None."""
    steps = _complete_steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str, step: int | None = None) -> dict:
    """Load a committed checkpoint's manifest without touching the arrays.

    The stream subsystem restores in two phases: the manifest's ``extra``
    carries the tree geometry (max_nodes, capacity, ...) needed to build
    the restore *template*, plus the WAL sequence number where tail replay
    must resume (repro.stream.pipeline)."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {directory!r}")
    with open(os.path.join(_step_dir(directory, step), _MANIFEST)) as f:
        return json.load(f)


def _from_host(arr: np.ndarray, dtype: str, like) -> torch.Tensor:
    """A stored leaf as a tensor on the device of the template leaf
    ``like`` (the CPU when it is not a tensor)."""
    if dtype == "bfloat16":             # stored as its uint16 bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        if dtype != str(arr.dtype):
            arr = arr.view(np.dtype(dtype))
        t = torch.from_numpy(arr)
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


def restore_checkpoint(directory: str, template, *, step: int | None = None):
    """Load a checkpoint into the structure of ``template``.

    Returns (tree, manifest); every leaf lands on the device of the
    template's leaf."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {directory!r}")
    path = _step_dir(directory, step)
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves_t = _leaves(template)
    if manifest["n_leaves"] != len(leaves_t):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"template has {len(leaves_t)}")
    out = []
    with np.load(os.path.join(path, _ARRAYS), allow_pickle=False) as z:
        for i, tmpl in enumerate(leaves_t):
            out.append(_from_host(z[_leaf_name(i)],
                                  manifest["leaves"][i]["dtype"], tmpl))
    return _unflatten(template, iter(out)), manifest


class CheckpointManager:
    """Rotating checkpoint writer with optional async (background-thread)
    serialization.

    ``save`` always snapshots leaves to host *synchronously* — callers may
    write the tensors in place right after — and only the file write is
    deferred.  ``wait()`` drains pending writes (call before exit)."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True, fsync_dir: bool = False):
        self.directory = directory
        self.keep = keep
        self.fsync_dir = fsync_dir
        self._lock = threading.Lock()
        self._pending: list[Future] = []
        self._pool = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="ckpt")
                      if async_write else None)

    def save(self, step: int, tree, extra: dict | None = None) -> None:
        host = _to_host(tree)
        if self._pool is None:
            _write(self.directory, step, host, extra, self.fsync_dir)
            self._rotate()
            return
        with self._lock:
            # surface earlier async failures *now*, not at final wait():
            # a full disk at step 1k must not let a 100k-step run believe
            # it is checkpointed.  Also prunes completed futures.
            done = [f for f in self._pending if f.done()]
            self._pending = [f for f in self._pending if not f.done()]
            for fut in done:
                fut.result()
            self._pending.append(
                self._pool.submit(self._write_and_rotate, step, host, extra))

    def _write_and_rotate(self, step, host, extra):
        _write(self.directory, step, host, extra, self.fsync_dir)
        self._rotate()

    def _rotate(self) -> None:
        steps = _complete_steps(self.directory)
        for old in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(_step_dir(self.directory, old), ignore_errors=True)

    def wait(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def latest_step(self) -> int | None:
        return latest_step(self.directory)

    def restore_latest(self, template):
        self.wait()
        return restore_checkpoint(self.directory, template)
