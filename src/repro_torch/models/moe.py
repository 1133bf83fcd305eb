"""Mixture-of-Experts FFN on the paper's bucket-aggregation machinery
(``repro.models.moe``).

A token choosing an expert is a pulse event choosing a destination chip:

  router top-k             == routing-LUT lookup (fan-out K = top_k)
  capacity-factor buckets  == bucket buffers ([E, C] slabs, FIFO-stable)
  token dropping           == bucket overflow (identical accounting)
  weighted combine         == destination merge

Slot assignment is :func:`repro_torch.core.buckets.compute_slots_sorted`,
the rank-within-bucket rule of the event path in its sort form.  Routing,
dispatch, the expert products and the combine are plain PyTorch, as the
reference's are XLA code outside any Pallas kernel; the expert products
are batched matrix products (``torch.bmm``) over the experts.

Where the reference leaves the order of operations to XLA, the port fixes
it so that two calls on the card give the same bits and use no atomics:

* top-k is the head of a stable descending sort, so equal probabilities
  go to the lower expert first, as ``jax.lax.top_k`` orders them;
* the dispatch writes each kept lane's token into its ``(expert, slot)``
  cell by one ``index_put`` (kept cells are unique; dropped lanes land on
  one extra row past the slab, which is discarded);
* the combine gathers each lane's expert output (:class:`_CellGather`,
  whose backward writes the unique cells back without accumulating) and
  adds a token's k lanes one after another in lane order, in x's type,
  as the reference's scatter-add does; no ``index_add_``.

The local dispatch splits the tokens into G data groups, G the data
shards the rules give the batch (``_data_groups``; 1 without rules, as
on the reference's CPU path), each ranked with its own capacity.  The
``shard`` constraints of the reference (the dispatched slabs, the hidden
products, the expert outputs, the combine) stand where it puts them;
without rules, or on plain tensors, they change nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import buckets as bk
from repro_torch.models.sharding import Rules, shard
from repro_torch.models.spec import ParamSpec


def moe_spec(cfg: ArchConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), (None, None), init="small_normal"),
        "w_gate": ParamSpec((e, d, f), ("experts", None, None),
                            fan_in_dims=(1,)),
        "w_up": ParamSpec((e, d, f), ("experts", None, None),
                          fan_in_dims=(1,)),
        "w_down": ParamSpec((e, f, d), ("experts", None, None),
                            fan_in_dims=(1,)),
    }


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Bucket capacity: ceil(T k / E cf), aligned up to 8 lanes."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, -(-c // 8) * 8)


def _data_groups(rules: Rules | None, batch: int) -> int:
    """Number of data shards the token stream is split across (1 without
    rules)."""
    if rules is None:
        return 1
    fitted = rules._fit(rules.mesh_axis("batch"), batch)
    if fitted is None:
        return 1
    if isinstance(fitted, str):
        fitted = (fitted,)
    g = 1
    for a in fitted:
        g *= rules._axis_size(a)
    return g


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """Router logits in float32, softmax, the top k by a stable descending
    sort and the gates renormalised over the k picks: x [..., d] ->
    (probs [..., E], gate [..., k] f32, expert_idx [..., k] int64)."""
    probs = torch.softmax(torch.matmul(x.float(), router.float()), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[..., :k], idx[..., :k]
    return probs, gate / gate.sum(-1, keepdim=True), idx


class _CellGather(torch.autograd.Function):
    """``src[code]`` on rows, for codes unique but for the discarded last
    row: the backward writes each lane's gradient back to its row by a
    plain ``index_put`` instead of the accumulating scatter (atomics on
    the card) that autograd's gather would use."""

    @staticmethod
    def forward(ctx, src, code):
        ctx.save_for_backward(code)
        ctx.rows = src.shape[0]
        return src[code]

    @staticmethod
    def backward(ctx, grad):
        (code,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.rows,) + grad.shape[1:])
        return out.index_put_((code,), grad), None


def _experts(p: dict, xd: torch.Tensor, pin) -> torch.Tensor:
    """SwiGLU experts on the slabs: xd [E, rows, d] -> [E, rows, d];
    ``pin`` places the hidden product and the output."""
    dt = xd.dtype
    gate_h = torch.bmm(xd, p["w_gate"].to(dt))
    up_h = torch.bmm(xd, p["w_up"].to(dt))
    h = pin(F.silu(gate_h) * up_h)
    return pin(torch.bmm(h, p["w_down"].to(dt)))


def _pin(rules: Rules | None, local: bool, g: int):
    """The reference's constraint on the expert slabs, as a function of
    the port's [E, G cap, n] layout: ``("batch", "experts", None, None)``
    on the [G, E, cap, n] view in the local dispatch, ``("experts", None,
    None)`` in the global one (G 1)."""
    if rules is None:
        return lambda t: t
    if not local:
        return lambda t: shard(t, rules, "experts", None, None)

    def pin(t):
        e, rows, n = t.shape
        v = t.reshape(e, g, rows // g, n).transpose(0, 1)
        v = shard(v, rules, "batch", "experts", None, None)
        return v.transpose(0, 1).reshape(e, rows, n)

    return pin


def _dispatch(x: torch.Tensor, expert: torch.Tensor, slot: torch.Tensor,
              keep: torch.Tensor, e: int, cap: int) -> tuple:
    """Tokens x [G, T, d] into slabs [G, E, cap, d] by their lanes [G, T,
    k] (token-major, then k).  Returns the slabs and each lane's cell code
    in ``[0, G E cap]`` (``G E cap`` for a dropped lane)."""
    g, t, d = x.shape
    k = expert.shape[-1]
    cells = g * e * cap
    group = torch.arange(g, device=x.device)[:, None, None] * (e * cap)
    code = torch.where(keep, group + expert * cap + slot, cells).reshape(-1)
    lanes = x[:, :, None, :].expand(g, t, k, d).reshape(g * t * k, d)
    slab = torch.index_put(x.new_zeros((cells + 1, d)), (code,), lanes)
    return slab[:cells].reshape(g, e, cap, d), code


def _combine(ye: torch.Tensor, code: torch.Tensor, gate: torch.Tensor,
             keep: torch.Tensor) -> torch.Tensor:
    """Expert outputs ye [G, E, cap, d] back to tokens [G, T, d]: each
    lane's row times its gate (zero where dropped), a token's k lanes
    added one after another in x's type."""
    g, e, cap, d = ye.shape
    t, k = gate.shape[1], gate.shape[2]
    rows = torch.cat([ye.reshape(g * e * cap, d), ye.new_zeros((1, d))])
    y = _CellGather.apply(rows, code).reshape(g, t, k, d)
    y = y * (gate * keep.float()).to(ye.dtype)[..., None]
    out = y[:, :, 0]
    for j in range(1, k):
        out = out + y[:, :, j]
    return out


def _metrics(probs, counts, keep, cap: int, e: int) -> dict:
    """The reference's accounting, as ``CommStats`` counts buckets: the
    load-balancing loss, the dropped share and the bucket fill."""
    assigned = keep.numel()
    dropped = assigned - keep.sum(dtype=torch.int32)
    frac = counts.reshape(-1, e).sum(0).float() / assigned
    mean_prob = probs.reshape(-1, e).mean(0)
    return {
        "aux_loss": e * torch.sum(frac * mean_prob),
        "drop_fraction": dropped.float() / assigned,
        "bucket_utilization": torch.mean(
            torch.clamp(counts, max=cap).float()) / cap,
    }


def _apply(cfg: ArchConfig, p: dict, x: torch.Tensor, g: int, cap: int,
           routing: dict | None, rules: Rules | None, local: bool):
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    xg = x.reshape(g, b * s // g, d)
    probs, gate, idx = route(xg, p["router"], k)                # [G, Tl, *]
    lanes = idx.reshape(g, -1)                                  # [G, Tl k]
    slot, counts = bk.compute_slots_sorted(
        lanes, torch.ones_like(lanes, dtype=torch.bool), e)
    slot = slot.reshape(idx.shape).long()
    keep = slot < cap
    xd, code = _dispatch(xg, idx, slot, keep, e, cap)
    pin = _pin(rules, local, g)
    ye = _experts(p, pin(xd.transpose(0, 1).reshape(e, g * cap, d)), pin)
    ye = ye.reshape(e, g, cap, d).transpose(0, 1)
    out = shard(_combine(ye, code, gate, keep).reshape(b, s, d), rules,
                "batch", None, None)
    if routing is not None:
        routing.update(expert_idx=idx, slot=slot, keep=keep, counts=counts,
                       gate=gate, probs=probs, capacity=cap)
    return out, _metrics(probs, counts, keep, cap, e)


def moe_apply_local(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
                    rules: Rules | None = None,
                    routing: dict | None = None):
    """Shard-local dispatch (``cfg.moe_dispatch == "local"``): tokens are
    ranked within each of G data groups (``_data_groups(rules, B)``),
    each with a local capacity of C / G (aligned up to 8), as each source
    chip packs its own buckets.  With ample capacity the output equals
    :func:`moe_apply`'s."""
    g = _data_groups(rules, x.shape[0])
    t = x.shape[0] * x.shape[1]
    cap = max(8, -(-capacity(cfg, t) // (8 * g)) * 8)
    return _apply(cfg, p, x, g, cap, routing, rules, True)


def moe_apply(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
              rules: Rules | None = None, routing: dict | None = None):
    """x [B, S, d] -> (y [B, S, d] in x's type, metrics {"aux_loss",
    "drop_fraction", "bucket_utilization"}).  Capacity is
    ``capacity(cfg, B S)``: it depends on the tokens of the call.  A dict
    passed as ``routing`` receives the integer routing (``expert_idx``,
    ``slot``, ``keep``, ``counts``, each with a leading group axis), the
    gates, the router's probabilities and the capacity."""
    if cfg.moe_dispatch == "local":
        return moe_apply_local(cfg, p, x, rules=rules, routing=routing)
    return _apply(cfg, p, x, 1, capacity(cfg, x.shape[0] * x.shape[1]),
                  routing, rules, False)
