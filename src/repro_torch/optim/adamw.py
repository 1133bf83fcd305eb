"""AdamW with global-norm clipping (``repro.optim.adamw`` on one device).

Functional, as the reference: ``init`` builds the state, ``update`` maps
(grads, state, params) to (new_params, new_state, metrics) without
touching its arguments, so a state kept by the caller (a checkpoint, a
drill's initial state) stays valid.  The moments are float32; each
parameter is updated in float32 and cast back to its type.  The state is
a NamedTuple with the reference's fields, so checkpoints carry the
reference's keys (``opt/count``, ``opt/m/...``, ``opt/v/...``).

ZeRO-1: ``zero_pspecs`` gives the moments the parameters' specs with
their largest replicated dimension also sharded over the data axes
where it divides; ``zero_state_pspecs`` the whole state's specs.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.sharding import PartitionSpec, Rules
from repro_torch.models.spec import ParamSpec, pspec_tree, tree_leaves, tree_map

F32 = torch.float32


class AdamWState(NamedTuple):
    count: torch.Tensor     # int32 scalar
    m: Any
    v: Any


def _device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def init(params: Any) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)  # noqa: E731
    return AdamWState(
        count=torch.zeros((), dtype=torch.int32, device=_device(params)),
        m=tree_map(zeros, params), v=tree_map(zeros, params))


def state_shapes(param_shapes: Any) -> AdamWState:
    """The state's shapes and types as tensors on the ``meta`` device
    (the reference's ``ShapeDtypeStruct`` stand-ins); ``param_shapes`` is
    any tree of objects with a ``shape``."""
    f = lambda p: torch.empty(p.shape, dtype=F32, device="meta")  # noqa: E731
    return AdamWState(count=torch.empty((), dtype=torch.int32, device="meta"),
                      m=tree_map(f, param_shapes),
                      v=tree_map(f, param_shapes))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's leaf order) of each
    leaf's sum of squares in float32."""
    sq = sum(torch.sum(torch.square(x.to(F32))) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def update(grads: Any, state: AdamWState, params: Any, *, lr,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1,
           clip_norm: float = 1.0) -> tuple[Any, AdamWState, dict]:
    """One AdamW step with the reference's arithmetic: the gradients
    scaled by min(1, clip_norm / (|g| + 1e-9)), bias-corrected moments,
    decoupled weight decay on every leaf.  ``lr`` is a float or a float32
    scalar tensor.  Runs without autograd."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
        count = state.count + 1
        c1 = 1.0 - b1 ** count.to(F32)
        c2 = 1.0 - b2 ** count.to(F32)

        def one(g, m, v, p):
            g = g.to(F32) * scale
            m_new = b1 * m + (1.0 - b1) * g
            v_new = b2 * v + (1.0 - b2) * g * g
            upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            upd = upd + weight_decay * p.to(F32)
            p_new = p.to(F32) - lr * upd
            return p_new.to(p.dtype), m_new, v_new

        out = _zip_map(one, grads, state.m, state.v, params)
        new_params, new_m, new_v = (_zip_map(lambda t, i=i: t[i], out)
                                    for i in range(3))
    metrics = {"grad_norm": gnorm, "clip_scale": scale}
    return new_params, AdamWState(count=count, m=new_m, v=new_v), metrics


def _zip_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure (anything
    but a dict is a leaf), keys in sorted order."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# ZeRO-1 sharding of the moment trees
# ---------------------------------------------------------------------------

def zero_pspecs(spec_tree: Any, rules: Rules) -> Any:
    """Moment-tree PartitionSpecs: the parameter's spec, and its largest
    replicated dimension sharded over the data axes where the data size
    divides it."""
    data_axes = rules.batch_axes
    data_size = 1
    for a in data_axes:
        data_size *= rules._axis_size(a)

    def one(s: ParamSpec):
        mesh_axes = [rules._fit(rules.mesh_axis(a), d)
                     for a, d in zip(s.axes, s.shape)]
        best, best_dim = -1, -1
        for i, (n, ax) in enumerate(zip(s.shape, mesh_axes)):
            if ax is None and n % data_size == 0 and n > best:
                best, best_dim = n, i
        if best_dim >= 0:
            mesh_axes[best_dim] = (data_axes if len(data_axes) > 1
                                   else data_axes[0])
        return PartitionSpec(*mesh_axes)

    return tree_map(one, spec_tree)


def zero_state_pspecs(spec_tree: Any, rules: Rules) -> AdamWState:
    moments = zero_pspecs(spec_tree, rules)
    return AdamWState(count=PartitionSpec(), m=moments, v=moments)


def param_pspecs(spec_tree: Any, rules: Rules) -> Any:
    return pspec_tree(spec_tree, rules)
