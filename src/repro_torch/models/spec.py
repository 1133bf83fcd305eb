"""Parameter-spec trees: one source of truth for shapes, init and
sharding (``repro.models.spec``).

A model's parameters are a nested dict of :class:`ParamSpec` (shape,
logical axis names, init rule).  From the same tree come

  * ``init_tree``     -- materialized parameters, drawn from a
    ``torch.Generator`` with the reference's distributions (the numbers
    differ from ``jax.random``'s; tests carry weights across with
    ``convert.lm_params_from_jax``);
  * ``shape_tree``    -- tensors on the ``meta`` device, the reference's
    ``ShapeDtypeStruct`` stand-ins (no allocation);
  * ``pspec_tree``    -- a ``sharding.PartitionSpec`` per leaf;
  * ``sharding_tree`` -- the DTensor placements per leaf.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch


class ParamSpec(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple[Any, ...]          # logical axis name (str) or None per dim
    init: str = "normal"           # normal | zeros | ones | small_normal
    fan_in_dims: tuple[int, ...] = (0,)
    dtype: Any = None              # None -> model dtype

    def scale(self) -> float:
        fan_in = 1
        for d in self.fan_in_dims:
            fan_in *= self.shape[d]
        return 1.0 / math.sqrt(max(fan_in, 1))


def tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict (a ``ParamSpec`` or a tensor
    is a leaf), keys in sorted order as ``jax.tree`` flattens them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def unstack(tree, n: int) -> list:
    """The ``n`` slices of a tree stacked on its leading axis, as views.
    One unbind per leaf: its backward stacks the slices' gradients once,
    where a select per slice would fill a zero tensor of the whole stack
    for each."""
    leaves = tree_map(lambda x: x.unbind(0), tree)
    return [tree_map(lambda xs, r=r: xs[r], leaves) for r in range(n)]


# The most float32 elements one draw of ``init_tree`` holds (64 MiB).
DRAW_ELEMS = 1 << 24


def init_tree(gen: torch.Generator, tree, dtype: torch.dtype,
              device) -> dict:
    """Materialize a spec tree: ``normal`` draws N(0, 1/fan_in),
    ``small_normal`` N(0, 0.02^2).  Each leaf is allocated once, in its
    own type on ``device``, and filled a block at a time
    (:func:`fill_normal`): float32 from ``gen`` (on its own device, one
    stream in leaf order), scaled in place, then copied in.  No float32
    scratch holds more than one block, so a stacked leaf of 34 GB in
    float32 fills a 17 GB bf16 tensor."""

    def one(spec: ParamSpec) -> torch.Tensor:
        dt = spec.dtype or dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        out = torch.empty(spec.shape, dtype=dt, device=device)
        scale = 0.02 if spec.init == "small_normal" else spec.scale()
        fill_normal(out, gen, scale, DRAW_ELEMS)
        return out

    return tree_map(one, tree)


def fill_normal(out: torch.Tensor, gen: torch.Generator, scale: float,
                draw_elems: int) -> None:
    """Fill ``out`` (contiguous) with N(0, scale^2) along its leading axis:
    a block of as many leading slices as ``draw_elems`` holds (at least
    one) at a time; a slice larger than that is filled the same way along
    its own leading axis.  Each block is drawn in float32 from ``gen``,
    in order, so the values depend on the seed, the shape and
    ``draw_elems`` alone, not on ``out``'s type or device."""
    if out.dim() <= 1 or out.numel() <= draw_elems:
        flat = out.view(-1)
        for start in range(0, flat.numel(), draw_elems):
            part = flat[start:start + draw_elems]
            x = torch.randn(part.shape, generator=gen, dtype=torch.float32,
                            device=gen.device)
            part.copy_(x.mul_(scale))
        return
    per = out[0].numel()
    if per > draw_elems:
        for row in out:
            fill_normal(row, gen, scale, draw_elems)
        return
    rows = draw_elems // per
    for start in range(0, out.shape[0], rows):
        fill_normal(out[start:start + rows], gen, scale, draw_elems)


def shape_tree(tree, dtype: torch.dtype) -> dict:
    """Each spec as an empty tensor of its shape and type on the ``meta``
    device."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype or dtype,
                                          device="meta"), tree)


def pspec_tree(tree, rules) -> dict:
    """Each spec's ``PartitionSpec`` under ``rules``
    (:class:`repro_torch.models.sharding.Rules`)."""
    return tree_map(lambda s: rules.pspec(s.axes, s.shape), tree)


def sharding_tree(tree, rules) -> dict:
    """Each spec's DTensor placements under ``rules``."""
    return tree_map(lambda s: rules.sharding(s.axes, s.shape), tree)


def stack_specs(tree, n: int, axis_name=None):
    """Prepend a stacking dimension (the repeats of the layer pattern)."""
    return tree_map(lambda s: ParamSpec(
        shape=(n,) + s.shape, axes=(axis_name,) + s.axes, init=s.init,
        fan_in_dims=tuple(d + 1 for d in s.fan_in_dims), dtype=s.dtype),
        tree)


def count_params(tree) -> int:
    total = 0
    for leaf in tree_leaves(tree):
        total += math.prod(leaf.shape)
    return total
