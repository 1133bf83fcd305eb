"""Logical-axis sharding rules (``repro.models.sharding``) over
``torch.distributed`` device meshes.

Every parameter and activation dimension carries a logical name; ``Rules``
maps logical names onto mesh axes (Megatron-style 2D TP x DP):

  batch                         -> data axes (+"pod")
  heads / kv_heads / ff / experts / vocab / d_inner / ssm_heads -> "model"
  embed / seq / d_head / state / window ...                      -> replicated
  seq_shard -> "model" (sequence parallelism for long-context cells)

``pspec`` gives the reference's PartitionSpec as the port's own
:class:`PartitionSpec` (a tuple of entries, each a mesh-axis name, a
tuple of names or None); ``sharding`` gives the DTensor placements over
the mesh: ``Shard(d)`` on each mesh dimension that tensor dimension ``d``
maps to, else ``Replicate()``.  A tensor dimension over two mesh axes
(``("pod", "data")``, ``("kv", "mp")``) is sharded on both, the first
axis the outer one, as the reference's spec lays it out; that needs the
axes in mesh order, and any other order raises.

The mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` of
``launch/mesh.py``, or any object whose ``shape`` maps axis names to
sizes (a shape-only stand-in, which serves the divisibility rules without
a process group).  The models take ``rules=None`` by default, and then
every constraint is a no-op, as on the reference's CPU path.
"""

from __future__ import annotations

import dataclasses
from typing import Any

TENSOR_AXES = frozenset(
    {"heads", "kv_heads", "ff", "experts", "vocab", "d_inner", "ssm_heads",
     "seq_shard"}
)


class PartitionSpec(tuple):
    """The reference's ``jax.sharding.PartitionSpec``: one entry a tensor
    dimension, each a mesh-axis name, a tuple of names or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (by its
    ``mesh_dim_names``) or of a stand-in whose ``shape`` is that
    mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(n) for n in mesh.shape)))
    return {name: int(n) for name, n in dict(mesh.shape).items()}


@dataclasses.dataclass(frozen=True)
class Rules:
    mesh: Any
    batch_axes: tuple[str, ...] = ("data",)
    tensor_axis: str | tuple[str, ...] = "model"
    kv_axis: str | None = None   # kv-factored mesh: shard kv_heads on a
                                 # sub-axis of the tensor tier (serving)

    def mesh_axis(self, logical: str | None):
        if logical is None:
            return None
        if logical == "batch":
            return self.batch_axes
        if logical == "kv_heads" and self.kv_axis is not None:
            return self.kv_axis
        if logical in TENSOR_AXES:
            return self.tensor_axis
        return None

    def _axis_size(self, name: str) -> int:
        return axis_sizes(self.mesh)[name]

    def _fit(self, mesh_axes, dim: int | None):
        """Divisibility fallback: drop mesh axes (outermost first) until
        the dim divides: kv_heads 8 on a 16-way model axis replicates, a
        global batch of 1 cannot data-shard, a 2 x 16 ("pod", "data")
        batch mapping degrades to ("data",) when only 16 divides."""
        if mesh_axes is None or dim is None:
            return mesh_axes
        axes = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
        while axes:
            prod = 1
            for a in axes:
                prod *= self._axis_size(a)
            if dim % prod == 0:
                return axes if len(axes) > 1 else axes[0]
            axes = axes[1:]
        return None

    def pspec(self, axes: tuple[str | None, ...],
              shape: tuple[int, ...] | None = None) -> PartitionSpec:
        resolved = [self.mesh_axis(a) for a in axes]
        if shape is not None:
            resolved = [self._fit(m, d) for m, d in zip(resolved, shape)]
        return PartitionSpec(*resolved)

    def sharding(self, axes: tuple[str | None, ...],
                 shape: tuple[int, ...] | None = None) -> tuple:
        """The DTensor placements of ``pspec(axes, shape)``, one a mesh
        dimension."""
        return placements(self.mesh, self.pspec(axes, shape))


def placements(mesh, spec: PartitionSpec) -> tuple:
    """``Shard(d)`` on each mesh dimension that entry ``d`` of ``spec``
    names, ``Replicate()`` on the others.  Raises on an axis the mesh
    lacks, an axis named twice, or a tuple of axes out of mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        where = []
        for a in group:
            if a not in names:
                raise ValueError(f"mesh axis {a!r} of {spec} is not in the "
                                 f"mesh's axes {names}")
            where.append(names.index(a))
        if where != sorted(where):
            raise ValueError(f"{spec}: the axes {group} of dimension {d} are "
                             f"not in mesh order {names}; DTensor shards a "
                             f"dimension over mesh dimensions outer first")
        for i in where:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards "
                                 f"two dimensions")
            out[i] = Shard(d)
    return tuple(out)


def from_mesh(mesh) -> Rules:
    names = tuple(axis_sizes(mesh))
    batch = ("pod", "data") if "pod" in names else ("data",)
    if "kv" in names:
        return Rules(mesh=mesh, batch_axes=batch,
                     tensor_axis=("kv", "mp"), kv_axis="kv")
    return Rules(mesh=mesh, batch_axes=batch)


def shard(x, rules: Rules | None, *axes: str | None):
    """The reference's ``with_sharding_constraint`` by logical axis names:
    ``x`` itself without rules; with rules the rank is checked, a DTensor
    is redistributed to the rules' placements, and a plain tensor (the
    local view, on one device or inside the data-parallel step) is
    returned unchanged.  It changes layout, never values."""
    if rules is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"rank mismatch: {len(axes)} axes for shape "
                         f"{tuple(x.shape)}")
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(rules.mesh,
                              rules.sharding(tuple(axes), tuple(x.shape)))
    return x
