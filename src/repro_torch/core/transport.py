"""Transports: the exchange of the chips' slabs (port of
``repro.core.transport``).

* :class:`LocalTransport`, every chip on one device with an explicit
  chip axis: a block ``[n_chips(src), n_chips(dst), ...]`` is exchanged
  by swapping its two leading axes.
* :class:`DistributedTransport`, the counterpart of the reference's
  ``ShardMapTransport``: the chips spread over the ranks of a
  ``torch.distributed`` device mesh, the exchange one
  ``all_to_all_single`` (hierarchical, innermost axis first, over an
  axis tuple).

A rank holds a contiguous block of ``n_local = n_chips // world`` chips
on the leading axis: rank r (outer-major over the axes, as the
reference's ``chip_index``) holds global chips ``[r * n_local, (r + 1) *
n_local)``.  ``n_local == 1`` is the reference's layout (one chip per
device); one GPU runs ``world == 1`` with every chip on its rank.  Both
transports share the protocol below, so one fabric drives either.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

I32 = torch.int32


def require_process_group() -> None:
    """Raise unless ``torch.distributed`` has a default process group: a
    shard transport never falls back to the local path."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "the shard forms exchange through torch.distributed: call "
            "torch.distributed.init_process_group (nccl on GPUs, gloo on "
            "the CPU) first")


def _off_chip(x: torch.Tensor, mine: torch.Tensor) -> torch.Tensor:
    """Each source row's valid words minus those addressed to its own
    chip (global index ``mine[row]``), ``int32 [rows, 1]``."""
    valid = (x >= 0).flatten(2)
    rows = torch.arange(x.shape[0], device=x.device)
    return (valid.sum((1, 2), dtype=I32)
            - valid[rows, mine.long()].sum(-1, dtype=I32))[:, None]


@dataclasses.dataclass(frozen=True)
class LocalTransport:
    """Every chip on one device, every pair one hop with no latency: the
    exchange swaps the source and destination chip axes (a view).  The
    same two halves as a routed transport's, so one exchange drives
    both."""

    n_chips: int

    @property
    def n_local(self) -> int:
        return self.n_chips

    @property
    def rows(self) -> slice:
        """The global chips of the leading axis."""
        return slice(0, self.n_chips)

    def chip_index(self, device=None) -> torch.Tensor:
        return torch.arange(self.n_chips, dtype=I32, device=device)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(0, 1)

    def put(self, x: torch.Tensor, perm) -> torch.Tensor:
        """Chip ``dst`` receives chip ``src``'s row for each ``(src,
        dst)`` in ``perm``; chips that receive nothing get zeros."""
        out = torch.zeros_like(x)
        for src, dst in perm:
            out[dst] = x[src]
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Every chip sees the sum over the chips."""
        return x.sum(0, keepdim=True, dtype=x.dtype).expand(x.shape).clone()

    def exchange_words_start(self, x: torch.Tensor):
        """Move a block ``[n_chips(src), n_chips(dst), ...]``; its link
        words ``[n_chips, 1]`` are each source chip's off-chip words (its
        valid words minus those addressed to itself), its backlog zeros."""
        off_chip = _off_chip(x, self.chip_index(x.device))
        return x.transpose(0, 1), off_chip, torch.zeros_like(off_chip)

    def exchange_words_finish(self, y: torch.Tensor) -> torch.Tensor:
        """No path latency to apply."""
        return y


@dataclasses.dataclass(frozen=True)
class DistributedTransport:
    """The exchange over the ranks of ``mesh`` along ``axis`` (a name, or
    a tuple of names, outermost first): the counterpart of the
    reference's ``ShardMapTransport``.

    Each rank holds ``n_local`` chips (see the module docstring).  With
    an axis tuple, :meth:`all_to_all` runs one stage per axis, innermost
    first (the cheap local links), outermost last (pre-aggregated), as
    the reference's ``_a2a``; it is bitwise the flat exchange.
    """

    mesh: Any
    axis: str | tuple[str, ...]
    n_chips: int

    def __post_init__(self):
        require_process_group()
        if self.n_chips % self.world:
            raise ValueError(
                f"{self.n_chips} chips do not split evenly over {self.world} "
                f"ranks of mesh axes {self.axes}")

    @property
    def axes(self) -> tuple[str, ...]:
        return (self.axis,) if isinstance(self.axis, str) else tuple(
            self.axis)

    def _size(self, name: str) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(name))

    @property
    def world(self) -> int:
        """Ranks over the exchange's axes."""
        n = 1
        for a in self.axes:
            n *= self._size(a)
        return n

    @property
    def rank(self) -> int:
        """This rank's index over the axes, outer-major."""
        idx = 0
        for a in self.axes:
            idx = idx * self._size(a) + self.mesh.get_local_rank(a)
        return idx

    @property
    def n_local(self) -> int:
        return self.n_chips // self.world

    @property
    def rows(self) -> slice:
        """This rank's global chips."""
        return slice(self.rank * self.n_local, (self.rank + 1) * self.n_local)

    @property
    def device(self) -> torch.device:
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    def chip_index(self, device=None) -> torch.Tensor:
        """The global ids of the local rows, ``int32 [n_local]``."""
        r = self.rows
        return torch.arange(r.start, r.stop, dtype=I32,
                            device=device or self.device)

    # -- collectives ---------------------------------------------------------

    def _tiled(self, x: torch.Tensor, name: str, dim: int) -> torch.Tensor:
        """One tiled all-to-all over axis ``name``: dim ``dim`` (size G *
        S) is split into G chunks, chunk g goes to the g-th rank of the
        axis, and the chunk received from rank g takes its place."""
        moved = x.movedim(dim, 0).contiguous()
        out = torch.empty_like(moved)
        dist.all_to_all_single(out, moved, group=self.mesh.get_group(name))
        return out.movedim(0, dim)

    def _a2a(self, x: torch.Tensor, axes: tuple[str, ...],
             dim: int) -> torch.Tensor:
        """The reference's recursion: split this stage's dim [P * Q, ...]
        into [P, Q, ...] for axes (outer, *inner), exchange the inner
        stages in each outer block, then the outer stage."""
        if len(axes) == 1:
            return self._tiled(x, axes[0], dim)
        p = self._size(axes[0])
        y = x.reshape(x.shape[:dim] + (p, x.shape[dim] // p)
                      + x.shape[dim + 1:])
        y = self._a2a(y, axes[1:], dim + 1)
        return self._tiled(y, axes[0], dim).reshape(x.shape)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x [n_local(src), n_chips(dst), ...]`` to ``[n_local(dst),
        n_chips(src), ...]``: dst-major per destination rank, one exchange
        over the axes, then the source ranks' rows side by side."""
        w, n = self.world, self.n_local
        if x.shape[:2] != (n, self.n_chips):
            raise ValueError(f"leading dims {tuple(x.shape[:2])} != "
                             f"(n_local, n_chips) = ({n}, {self.n_chips})")
        rest = x.shape[2:]
        z = x.reshape((n, w, n) + rest).transpose(0, 1).transpose(1, 2)
        y = self._a2a(z.contiguous(), self.axes, 0)   # [w(src), dst, src]
        return y.transpose(0, 1).reshape((n, self.n_chips) + rest)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked along dim 0 in rank order, gathered
        innermost axis first."""
        gather = getattr(dist, "all_gather_single", None) or (
            dist.all_gather_into_tensor)
        for name in reversed(self.axes):
            out = x.new_empty((self._size(name) * x.shape[0],) + x.shape[1:])
            gather(out, x.contiguous(), group=self.mesh.get_group(name))
            x = out
        return x

    def put(self, x: torch.Tensor, perm) -> torch.Tensor:
        """Point-to-point: chip ``dst`` receives chip ``src``'s row of
        ``x [n_local, ...]`` for each ``(src, dst)`` in ``perm`` (global
        chips), by one ``batch_isend_irecv``; chips that receive nothing
        get zeros."""
        if len(self.axes) != 1:
            raise ValueError("point-to-point put is single-axis")
        group = self.mesh.get_group(self.axes[0])
        ranks = dist.get_process_group_ranks(group)
        n, me = self.n_local, self.rank
        out = torch.zeros_like(x)
        ops = []
        for src, dst in sorted(perm, key=lambda p: p[1]):
            s_rank, d_rank = src // n, dst // n
            if s_rank == me and d_rank == me:
                out[dst - me * n] = x[src - me * n]
            elif s_rank == me:
                ops.append(dist.P2POp(dist.isend,
                                      x[src - me * n].contiguous(),
                                      ranks[d_rank], group, tag=dst))
            elif d_rank == me:
                ops.append(dist.P2POp(dist.irecv, out[dst - me * n],
                                      ranks[s_rank], group, tag=dst))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``x [n_local, ...]``: every local row gets the sum over all
        chips (the local rows summed, then one ``all_reduce`` per
        axis)."""
        s = x.sum(0, keepdim=True, dtype=x.dtype)
        for name in self.axes:
            dist.all_reduce(s, group=self.mesh.get_group(name))
        return s.expand(x.shape).clone()

    # -- the exchange protocol -----------------------------------------------

    def exchange_words_start(self, x: torch.Tensor):
        """Move a block ``[n_local(src), n_chips(dst), ...]`` to
        ``[n_local(dst), n_chips(src), ...]``; link words ``[n_local, 1]``
        are each local chip's off-chip words (those addressed to its own
        global index excluded), its backlog zeros."""
        off_chip = _off_chip(x, self.chip_index(x.device))
        return self.all_to_all(x), off_chip, torch.zeros_like(off_chip)

    def exchange_words_finish(self, y: torch.Tensor) -> torch.Tensor:
        """No path latency to apply."""
        return y


def exchange_matrix(dest_chip: torch.Tensor, valid: torch.Tensor,
                    n_chips: int) -> torch.Tensor:
    """Event counts by destination chip, ``[..., n_chips]``.

    Destinations outside ``[0, n_chips)`` are dropped; negatives are
    pushed past ``n_chips`` first, as the reference does so that JAX's
    negative-index wrap cannot land them on a real chip.
    """
    dest = torch.where((dest_chip < 0) | (dest_chip >= n_chips), n_chips,
                       dest_chip).long()
    counts = torch.zeros(dest.shape[:-1] + (n_chips + 1,), dtype=I32,
                         device=dest.device)
    counts.scatter_add_(-1, dest, valid.to(I32))
    return counts[..., :n_chips]
