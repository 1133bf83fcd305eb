"""Atomic, async checkpointing of state trees (port of
``repro.checkpoint.store``).

Layout (one directory per step), the reference's byte for byte:

    <dir>/step_00000420/
        manifest.json     — leaf keys, per-leaf shape/dtype/file
        leaf_00000.npy    — one file per leaf
    <dir>/step_00000420.COMMITTED   — commit marker, written last

* **atomic**   — writes go to ``step_X.tmp`` and are renamed only after
  every file and the manifest are written; a crash mid-write never hides
  the latest good checkpoint (restore looks for the newest COMMITTED
  marker).
* **async**    — ``AsyncCheckpointer`` copies tensors to host memory on
  the caller's thread (a blocking copy, so a later in-place op on a CUDA
  tensor cannot reach the snapshot) and writes on a background thread.
* **placement** — restore puts each leaf on the target leaf's device, or
  on ``device`` when given.

A tree is any nesting of NamedTuples, tuples, lists and dicts; ``None``
is an empty subtree.  Leaf keys are what ``jax.tree_util.
tree_flatten_with_path`` gives (field names, sorted dict keys, sequence
indices, joined by ``/``), so a checkpoint written by either package's
store restores through the other's.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch

_COMMIT_SUFFIX = ".COMMITTED"

# numpy has no accelerator dtypes: they are stored as same-width uint
# views under their logical name in the manifest.
_EXOTIC_DTYPES = {
    "bfloat16": (torch.bfloat16, np.uint16, torch.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8),
}
_TORCH_EXOTIC = {v[0]: k for k, v in _EXOTIC_DTYPES.items()}


# -- trees --------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x):
    """``(keys, children, rebuild)`` of an inner node, None for a leaf."""
    if _is_namedtuple(x):
        return list(x._fields), list(x), lambda cs: type(x)(*cs)
    if isinstance(x, (tuple, list)):
        return (list(range(len(x))), list(x),
                lambda cs, t=type(x): t(cs))
    if isinstance(x, dict):
        keys = sorted(x)
        return keys, [x[k] for k in keys], lambda cs: type(x)(zip(keys, cs))
    return None


def tree_flatten_with_path(tree: Any) -> tuple[list, Callable]:
    """``([(path, leaf), ...], unflatten)``: leaves in JAX's order, each
    path a tuple of field names, dict keys and indices; ``unflatten``
    rebuilds the tree from a list of new leaves."""
    items = []

    def walk(x, path):
        if x is None:
            return lambda it: None
        node = _children(x)
        if node is None:
            items.append((path, x))
            return lambda it: next(it)
        keys, kids, rebuild = node
        subs = [walk(c, path + (k,)) for k, c in zip(keys, kids)]
        return lambda it: rebuild([s(it) for s in subs])

    build = walk(tree, ())
    return items, lambda leaves: build(iter(leaves))


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)[0]]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); ``None`` subtrees stay
    ``None``."""
    items, unflatten = tree_flatten_with_path(tree)
    others = [tree_leaves(r) for r in rest]
    for o in others:
        if len(o) != len(items):
            raise ValueError(f"tree_map: {len(items)} leaves vs {len(o)}")
    return unflatten([fn(leaf, *(o[i] for o in others))
                      for i, (_, leaf) in enumerate(items)])


def _flatten_with_paths(tree: Any):
    items, unflatten = tree_flatten_with_path(tree)
    return [("/".join(str(p) for p in path), leaf)
            for path, leaf in items], unflatten


# -- arrays -------------------------------------------------------------------

def _c_order(arr: np.ndarray) -> np.ndarray:
    """``arr`` in C order, 0-d kept 0-d (``np.save`` of another order
    would write another header)."""
    return np.asarray(arr, order="C")


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a C-ordered numpy array to store, and its logical dtype
    name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _TORCH_EXOTIC.get(t.dtype)
        if name is not None:
            _, np_view, t_view = _EXOTIC_DTYPES[name]
            arr = t.contiguous().view(t_view).numpy().view(np_view)
            return _c_order(arr), name
        arr = _c_order(t.numpy())
        return arr, arr.dtype.name
    arr = _c_order(np.asarray(leaf))
    return arr, arr.dtype.name


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _EXOTIC_DTYPES:
        t_dtype, _, t_view = _EXOTIC_DTYPES[dtype_name]
        raw = torch.from_numpy(_c_order(arr).view(
            {torch.int16: np.int16, torch.uint8: np.uint8}[t_view]))
        return raw.view(t_dtype)
    return torch.from_numpy(_c_order(arr))


def _target_dtype(leaf) -> torch.dtype:
    dtype = leaf.dtype
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name in _EXOTIC_DTYPES:
        return _EXOTIC_DTYPES[name][0]
    return torch.from_numpy(np.zeros((), dtype)).dtype


def _target_device(leaf, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    d = getattr(leaf, "device", None)
    if isinstance(d, torch.device) and d.type != "meta":
        return d
    return torch.device("cpu")


# -- the store ----------------------------------------------------------------

def step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


def save(tree: Any, base: str, step: int) -> str:
    """Synchronous save; returns the committed directory."""
    os.makedirs(base, exist_ok=True)
    final = step_dir(base, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    items, _ = _flatten_with_paths(tree)
    manifest = {"step": step, "leaves": {}}
    for i, (key, leaf) in enumerate(items):
        raw, dtype_name = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), raw)
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(raw.shape),
            "dtype": dtype_name,
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, final)                       # atomic on POSIX
    with open(final + _COMMIT_SUFFIX, "w") as f:
        f.write(str(step))
    return final


def _committed_steps(base: str) -> list[int]:
    steps = []
    for name in os.listdir(base):
        if name.endswith(_COMMIT_SUFFIX):
            try:
                steps.append(int(name[len("step_"):-len(_COMMIT_SUFFIX)]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(base: str) -> int | None:
    if not os.path.isdir(base):
        return None
    steps = _committed_steps(base)
    return steps[-1] if steps else None


# Leaf names of the reference's early three-array MergeBuffer.  A
# checkpoint carrying them where the target expects the packed word queue
# (one ``words`` leaf) predates the wire-word format and cannot be
# restored into it.
_PRE_WORD_MERGE_LEAVES = ("addr", "deadline", "valid")


def _stale_merge_hint(key: str, manifest_keys) -> str | None:
    if not key.endswith("/words") and key != "words":
        return None
    prefix = key[: -len("words")]
    if all(prefix + f in manifest_keys for f in _PRE_WORD_MERGE_LEAVES):
        return (
            f"checkpoint holds a pre-word-format MergeBuffer at "
            f"{prefix.rstrip('/') or '<root>'!r} (addr/deadline/valid "
            f"leaves) where the target expects the packed words queue; "
            f"this format cannot be migrated in place — re-initialize the "
            f"merge state (PulseFabric.init_merge()) instead of restoring "
            f"it"
        )
    return None


def restore(base: str, step: int, target: Any, *, device=None,
            strict: bool = True) -> Any:
    """Restore into the structure of ``target``, whose leaves give each
    restored tensor its shape and dtype (tensors, numpy arrays, or
    anything with ``shape`` and ``dtype``, such as tensors on the
    ``meta`` device).  Each leaf goes to its target leaf's device (the
    CPU for a leaf with none) unless ``device`` is given.

    ``strict`` (default) also rejects checkpoints whose manifest carries
    leaves the target does not request (a stale state format would
    otherwise restore a subset in silence).  Pass ``strict=False`` to
    restore a sub-tree deliberately.
    """
    d = step_dir(base, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    items, unflatten = _flatten_with_paths(target)
    if strict:
        extra = sorted(set(manifest["leaves"]) - {k for k, _ in items})
        if extra:
            hints = [h for h in (_stale_merge_hint(k, manifest["leaves"])
                                 for k, _ in items) if h]
            raise ValueError(
                f"checkpoint at {d} carries leaves the target does not: "
                f"{extra}" + ("; " + hints[0] if hints else
                              " (stale state format? pass strict=False to "
                              "restore a sub-tree deliberately)"))
    out = []
    for key, leaf in items:
        meta = manifest["leaves"].get(key)
        if meta is None:
            hint = _stale_merge_hint(key, manifest["leaves"])
            if hint:
                raise ValueError(hint)
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = _from_numpy(np.load(os.path.join(d, meta["file"])),
                          meta["dtype"])
        want_shape = tuple(leaf.shape)
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"{key}: checkpoint shape {tuple(arr.shape)} != target "
                f"{want_shape}")
        out.append(arr.to(device=_target_device(leaf, device),
                          dtype=_target_dtype(leaf)))
    return unflatten(out)


def gc_old(base: str, keep: int = 3) -> None:
    """Retain only the newest ``keep`` committed checkpoints."""
    if not os.path.isdir(base):
        return
    steps = _committed_steps(base)
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(step_dir(base, s), ignore_errors=True)
        try:
            os.remove(step_dir(base, s) + _COMMIT_SUFFIX)
        except OSError:
            pass


def _snapshot(leaf):
    """A host copy of a leaf that nothing else holds."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class AsyncCheckpointer:
    """Background-thread writer: snapshot on the caller's thread, IO off
    it."""

    def __init__(self, base: str):
        self.base = base
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Exception | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            tree, step = item
            try:
                save(tree, self.base, step)
            except Exception as e:  # surfaced on the next save()/wait()
                self._err = e
            finally:
                self._q.task_done()

    def save(self, tree: Any, step: int) -> None:
        if self._err:
            raise self._err
        # A blocking copy to host memory now, so the caller may change its
        # tensors in place as soon as this returns.
        self._q.put((tree_map(_snapshot, tree), step))

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join()
