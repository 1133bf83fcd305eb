"""Error-feedback gradient compression for the data-parallel all-reduce
(``repro.optim.compression``).

Two codecs, each with an error-feedback residual carried in the train
state (the compression error is added back to the next step's gradient,
so the bias telescopes):

  * int8 -- a scale per tensor (max |acc| / 127), stochastic rounding;
  * topk -- the k largest |acc| kept, k = max(1, int(n frac)), as a dense
            mask: what crosses the wire is the masked float32 tensor.

``compressed_psum`` applies codec -> all-reduce -> mean over a mesh's
data group.  As in the reference, the wire carries the dequantised
float32 values (the reference's SPMD simulation of the codecs), so the
numerics are the codec's and the collective moves float32; no int8 or
(index, value) transport.  ``wire_bytes`` counts what a real codec would
inject.

The stochastic rounding's noise, uniform in [-0.5, 0.5), comes from a
``torch.Generator`` that the caller seeds alike on every rank; one draw a
leaf, in the leaf order of the tree (sorted keys, the reference's), as
the reference splits one replicated key a leaf.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.spec import tree_leaves, tree_map

F32 = torch.float32


class EFState(NamedTuple):
    residual: Any  # tree matching the gradients (float32)


def ef_init(params: Any) -> EFState:
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params))


def _quantize_int8(x: torch.Tensor, noise: torch.Tensor):
    """(q int8, scale): scale = max|x| / 127 (1 where that is 0), q the
    clipped round-half-to-even of x / scale + noise."""
    scale = torch.max(torch.abs(x)) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale + noise), -127, 127)
    return q.to(torch.int8), scale


def _topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    """1 where |x| is at least the k-th largest |x|, else 0 (ties at the
    threshold are kept), in x's type."""
    flat = torch.abs(x.reshape(-1))
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat, k, sorted=False).values.min()
    return (torch.abs(x) >= thresh).to(x.dtype)


def _compress(g: torch.Tensor, residual: torch.Tensor, noise, *,
              method: str, topk_frac: float = 0.01):
    """:func:`compress_leaf` with the stochastic rounding's noise given
    (a tensor of g's shape, used by int8 only)."""
    acc = g.to(F32) + residual
    if method == "int8":
        q, scale = _quantize_int8(acc, noise)
        wire = q.to(F32) * scale
    elif method == "topk":
        wire = acc * _topk_mask(acc, topk_frac)
    elif method == "none":
        wire = acc
    else:
        raise ValueError(method)
    return wire, acc - wire


def compress_leaf(g: torch.Tensor, residual: torch.Tensor,
                  gen: torch.Generator | None, *, method: str,
                  topk_frac: float = 0.01):
    """(wire value f32 -- what crosses the network, new residual).  int8
    draws its noise from ``gen`` (on g's device); the others draw
    nothing."""
    noise = None
    if method == "int8":
        noise = torch.rand(g.shape, generator=gen, dtype=F32,
                           device=g.device) - 0.5
    return _compress(g, residual, noise, method=method, topk_frac=topk_frac)


def compressed_psum(grads: Any, ef: EFState, gen: torch.Generator | None,
                    mesh, axis_name: str = "data", *, method: str = "int8",
                    topk_frac: float = 0.01) -> tuple[Any, EFState]:
    """EF-compress each local gradient, all-reduce the wire values with a
    sum over the mesh's ``axis_name`` group (a ``DeviceMesh`` of
    ``launch/mesh.py``; one all-reduce a leaf) and divide by the group's
    size: (mean-reduced gradients, new EF state)."""
    import torch.distributed as dist

    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    out, new_res = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(ef.residual)):
        wire, res = compress_leaf(g, r, gen, method=method,
                                  topk_frac=topk_frac)
        dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
        out.append(wire / n)
        new_res.append(res)
    outs, ress = iter(out), iter(new_res)
    return (tree_map(lambda _: next(outs), grads),
            EFState(residual=tree_map(lambda _: next(ress), grads)))


def wire_bytes(grads: Any, *, method: str, topk_frac: float = 0.01) -> int:
    """Bytes each device injects per reduction under the codec (int8: the
    payload and a float32 scale; topk: (index, value) pairs of 4 + 4
    bytes; none: float32)."""
    total = 0
    for g in tree_leaves(grads):
        n = g.numel()
        if method == "int8":
            total += n + 4
        elif method == "topk":
            total += max(1, int(n * topk_frac)) * (4 + 4)
        else:
            total += n * 4
    return total
