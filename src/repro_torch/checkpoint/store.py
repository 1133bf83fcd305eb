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
  on ``device`` when given; with ``shardings`` (a ``(DeviceMesh,
  placements)`` per leaf) it returns DTensors, each rank keeping its own
  slice of the file (no collective), so a checkpoint written on one mesh
  loads onto another.
* **distributed save** — a tree with DTensor leaves is saved by every
  rank: the full tensors are gathered, rank 0 writes, and a barrier
  holds the others until the commit marker exists.  The files are the
  same bytes as a single process's save of the full tensors.

A tree is any nesting of NamedTuples, tuples, lists and dicts; ``None``
is an empty subtree.  Leaf keys are what ``jax.tree_util.
tree_flatten_with_path`` gives (field names, sorted dict keys, sequence
indices, joined by ``/``), so a checkpoint written by either package's
store restores through the other's.  A NamedTuple may name fields in a
``CHIP_FIRST`` class attribute: the port holds their leaves ``[B,
n_chips, ...]`` where the reference holds them chip-first (the pipelined
carry's block stats), so the store writes them with their first two
axes swapped and swaps them back on restore.
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


def _flatten(tree: Any) -> tuple[list, Callable]:
    """``([(path, leaf, chip_first), ...], unflatten)``: leaves in JAX's
    order, each path a tuple of field names, dict keys and indices, and
    ``chip_first`` whether the leaf lies below a field that its NamedTuple
    lists in ``CHIP_FIRST``; ``unflatten`` rebuilds the tree from a list
    of new leaves."""
    items = []

    def walk(x, path, swap):
        if x is None:
            return lambda it: None
        node = _children(x)
        if node is None:
            items.append((path, x, swap))
            return lambda it: next(it)
        keys, kids, rebuild = node
        names = getattr(type(x), "CHIP_FIRST", ()) if _is_namedtuple(x) \
            else ()
        subs = [walk(c, path + (k,), swap or k in names)
                for k, c in zip(keys, kids)]
        return lambda it: rebuild([s(it) for s in subs])

    build = walk(tree, (), False)
    return items, lambda leaves: build(iter(leaves))


def tree_flatten_with_path(tree: Any) -> tuple[list, Callable]:
    """``([(path, leaf), ...], unflatten)``: leaves in JAX's order, each
    path a tuple of field names, dict keys and indices; ``unflatten``
    rebuilds the tree from a list of new leaves."""
    items, unflatten = _flatten(tree)
    return [(path, leaf) for path, leaf, _ in items], unflatten


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
    """``([(key, leaf, chip_first), ...], unflatten)`` as :func:`_flatten`
    gives them, each path joined by ``/``."""
    items, unflatten = _flatten(tree)
    return [("/".join(str(p) for p in path), leaf, swap)
            for path, leaf, swap in items], unflatten


def _swap01(x, swap: bool):
    """``x`` with its first two axes swapped where ``swap``."""
    return x.swapaxes(0, 1) if swap else x


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


def _is_dtensor(leaf) -> bool:
    if not isinstance(leaf, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def save(tree: Any, base: str, step: int) -> str:
    """Synchronous save; returns the committed directory.  With DTensor
    leaves every rank of the process group must call it (the full
    tensors are gathered); rank 0 writes and the others wait for the
    commit."""
    final = step_dir(base, step)
    items, _ = _flatten_with_paths(tree)
    gathered = any(_is_dtensor(leaf) for _, leaf, _ in items)
    items = [(k, _swap01(leaf.full_tensor() if _is_dtensor(leaf) else leaf,
                         swap))
             for k, leaf, swap in items]
    if gathered:
        import torch.distributed as dist

        if dist.get_rank() == 0:
            _write(items, base, step)
        dist.barrier()
        return final
    _write(items, base, step)
    return final


def _write(items: list, base: str, step: int) -> None:
    os.makedirs(base, exist_ok=True)
    final = step_dir(base, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
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


def _is_sharding(x) -> bool:
    if not (isinstance(x, tuple) and len(x) == 2):
        return False
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(x[0], DeviceMesh)


def _sharding_leaves(target: Any, shardings: Any) -> list:
    """The ``(mesh, placements)`` (or None) of each leaf of ``target``,
    in leaf order: ``shardings`` follows the target's structure, a pair
    standing for every leaf below it and None for none."""
    out = []

    def walk(t, sh):
        if t is None:
            return
        node = _children(t)
        if node is None or sh is None or _is_sharding(sh):
            if node is None:
                out.append(sh)
            else:
                for kid in node[1]:
                    walk(kid, sh)
            return
        keys, kids, _ = node
        subs = ([sh.get(k) for k in keys] if isinstance(sh, dict)
                else list(sh))
        for kid, sub in zip(kids, subs):
            walk(kid, sub)

    walk(target, shardings)
    return out


def _distribute(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's slice of ``full`` under ``placements`` on ``mesh``
    (``Shard(d)`` cuts dim d into ``torch.chunk`` pieces, mesh dim by
    mesh dim; ``Replicate`` keeps it), as a DTensor.  No collective."""
    from torch.distributed.tensor import DTensor

    placements = tuple(placements)
    coord = mesh.get_coordinate()
    local = full
    for i, p in enumerate(placements):
        if p.is_shard():
            pieces = torch.chunk(local, mesh.size(i), dim=p.dim)
            local = (pieces[coord[i]] if coord[i] < len(pieces)
                     else local.narrow(p.dim, 0, 0))
        elif not p.is_replicate():
            raise ValueError(f"restore places leaves by Shard or Replicate, "
                             f"not {p}")
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device(
                  mesh.device_type))
    return DTensor.from_local(local.contiguous().to(device), mesh,
                              placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def restore(base: str, step: int, target: Any, *, device=None,
            strict: bool = True, shardings: Any = None) -> Any:
    """Restore into the structure of ``target``, whose leaves give each
    restored tensor its shape and dtype (tensors, numpy arrays, or
    anything with ``shape`` and ``dtype``, such as tensors on the
    ``meta`` device).  Each leaf goes to its target leaf's device (the
    CPU for a leaf with none) unless ``device`` is given.

    ``shardings`` (optional, the target's structure with a ``(DeviceMesh,
    placements)`` pair or None per leaf) returns each sharded leaf as a
    DTensor on its mesh: every rank reads the file and keeps its own
    slice, so a checkpoint written on one mesh loads onto another.

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
        extra = sorted(set(manifest["leaves"]) - {k for k, *_ in items})
        if extra:
            hints = [h for h in (_stale_merge_hint(k, manifest["leaves"])
                                 for k, *_ in items) if h]
            raise ValueError(
                f"checkpoint at {d} carries leaves the target does not: "
                f"{extra}" + ("; " + hints[0] if hints else
                              " (stale state format? pass strict=False to "
                              "restore a sub-tree deliberately)"))
    out = []
    for (key, leaf, swap), shd in zip(items,
                                      _sharding_leaves(target, shardings)):
        meta = manifest["leaves"].get(key)
        if meta is None:
            hint = _stale_merge_hint(key, manifest["leaves"])
            if hint:
                raise ValueError(hint)
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = _from_numpy(np.load(os.path.join(d, meta["file"])),
                          meta["dtype"])
        want_shape = tuple(leaf.shape)
        if swap:
            want_shape = want_shape[1::-1] + want_shape[2:]
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"{key}: checkpoint shape {tuple(arr.shape)} != target "
                f"{want_shape}" + (" (stored chip-first)" if swap else ""))
        arr = _swap01(arr, swap).contiguous()
        if shd is not None:
            out.append(_distribute(arr.to(_target_dtype(leaf)), *shd))
            continue
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
