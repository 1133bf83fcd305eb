"""Plain PyTorch versions of the flash-attention kernels.

* :func:`attention_ref`: exact softmax attention with GQA head grouping
  and a causal mask with ``q_offset``
  (``repro.kernels.flash_attention.ref.attention_ref``), and with
  ``window`` > 0 the sliding window of ``repro.models.attention``'s
  ``chunked_attention`` (query position i sees key j only where i - j <
  window), f32 inside;
  :func:`attention_with_lse_ref` also returns each row's log-sum-exp, the
  residual of the backward.
* :func:`attention_bwd_ref`: the backward, ``_chunked_attention_bwd`` of
  ``repro.models.attention`` (the reference trains through it) with its
  roundings, on whole rows instead of chunks.

A row with no valid key gives 0, as the kernel's ``l == 0`` guard does
(the JAX oracle would average such a row uniformly; neither the causal
nor the full mask ever leaves a row empty when ``q_offset >= 0`` and
``Skv > 0``, a window without the causal mask can), and its lse is
``finfo(float32).min``, as in ``_chunked_attention_fwd``."""

from __future__ import annotations

import torch

F32 = torch.float32
NEG_INF = torch.finfo(torch.float32).min


def _mask(sq: int, skv: int, causal: bool, q_offset: int, device,
          window: int = 0):
    """[Sq, Skv] bool: query row i (at position q_offset + i) sees key j:
    j <= q_offset + i where causal, and q_offset + i - j < window where
    ``window`` > 0."""
    col = torch.arange(skv, device=device)[None, :]
    row = torch.arange(sq, device=device)[:, None] + q_offset
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (row >= col)
    if window:
        mask = mask & (row - col < window)
    return mask


def attention_with_lse_ref(q, k, v, *, causal: bool = True,
                           scale: float | None = None, q_offset: int = 0,
                           window: int = 0):
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] -> (out [B, Hq, Sq, D] in q's
    type, lse [B, Hq, Sq] float32 in natural-log units)."""
    _, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    kr = k.to(F32).repeat_interleave(group, dim=1)
    vr = v.to(F32).repeat_interleave(group, dim=1)
    s = torch.matmul(q.to(F32), kr.transpose(-1, -2)) * scale
    mask = _mask(sq, skv, causal, q_offset, q.device, window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vr) / torch.where(l == 0, 1.0, l)
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)),
                      NEG_INF)
    return out.to(q.dtype), lse[..., 0]


def attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None,
                  q_offset: int = 0, window: int = 0) -> torch.Tensor:
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] -> [B, Hq, Sq, D] in q's
    type."""
    return attention_with_lse_ref(q, k, v, causal=causal, scale=scale,
                                  q_offset=q_offset, window=window)[0]


def _probabilities(q, k, lse, causal, scale, q_offset):
    """p = exp(s - lse) in f32, 0 where masked or on a row without a key;
    and k repeated over the query heads of its group, in f32."""
    sq, skv = q.shape[2], k.shape[2]
    kr = k.to(F32).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = torch.matmul(q.to(F32), kr.transpose(-1, -2)) * scale
    row_ok = lse > NEG_INF / 2
    p = torch.exp(s - torch.where(row_ok, lse, 0.0)[..., None])
    keep = _mask(sq, skv, causal, q_offset, q.device) & row_ok[..., None]
    return torch.where(keep, p, 0.0), kr


def _group_sum(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, Hq, S, D] summed over the query heads of each kv head."""
    b, hq, s, d = x.shape
    return x.reshape(b, hkv, hq // hkv, s, d).sum(dim=2)


def attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool = True,
                      scale: float | None = None, q_offset: int = 0):
    """The gradient of attention: (dq, dk, dv) in q's, k's and v's types,
    from out (the forward's output in its own type), lse [B, Hq, Sq]
    float32 and dout, with ``_chunked_attention_bwd``'s roundings: p
    recomputed in f32 as exp(s - lse); p rounded to v's type before dV;
    delta = rowsum(dout * out) in f32; ds = p (dp - delta) * scale rounded
    to q's type before dQ and dK; f32 sums.  Query head h belongs to kv
    head h // g."""
    hkv, d = k.shape[1], q.shape[-1]
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    p, kr = _probabilities(q, k, lse, causal, scale, q_offset)
    vr = v.to(F32).repeat_interleave(q.shape[1] // hkv, dim=1)
    do = dout.to(F32)
    dv = torch.matmul(p.to(v.dtype).to(F32).transpose(-1, -2), do)
    dp = torch.matmul(do, vr.transpose(-1, -2))
    delta = (do * out.to(F32)).sum(dim=-1)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).to(F32)
    dq = torch.matmul(ds, kr)
    dk = torch.matmul(ds.transpose(-1, -2), q.to(F32))
    return (dq.to(q.dtype), _group_sum(dk, hkv).to(k.dtype),
            _group_sum(dv, hkv).to(v.dtype))


def _magnitudes(q, k, v, out, lse, dout, causal, scale, q_offset):
    """The pieces of the backward's bounds, all f32: p, mag = p (|dout|
    |v| + |dout . out|) scale (which bounds p |dp - delta| scale), q, k
    and v repeated over the group, dout, out, and the scale."""
    if scale is None:
        scale = float(1.0 / (q.shape[-1] ** 0.5))
    p, kr = _probabilities(q, k, lse, causal, scale, q_offset)
    vr = v.to(F32).repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    do, of = dout.to(F32), out.to(F32)
    mag = p * (torch.matmul(do.abs(), vr.abs().transpose(-1, -2))
               + (do * of).abs().sum(dim=-1, keepdim=True)) * scale
    return p, mag, q.to(F32), kr, vr, do, of, scale


def _sums(w, qq, kk, hkv):
    """(w kk, the group's sum of w^T qq): a weight of every (query, key)
    pair carried into dq's and dk's shapes."""
    return (torch.matmul(w, kk),
            _group_sum(torch.matmul(w.transpose(-1, -2), qq), hkv))


def attention_bwd_bounds(q, k, v, out, lse, dout, *, causal: bool = True,
                         scale: float | None = None, q_offset: int = 0):
    """Elementwise bounds (float32 tensors shaped like dq, dk and dv) on
    how far two implementations of :func:`attention_bwd_ref`'s arithmetic
    that sum in other orders (the card's kernel, JAX's XLA code) may
    differ.

    With t the terms of an output element y (ds_j k_j for dq, ds_i q_i
    for dk, p_i dout_i for dv; at most 2^11 of them), and M the sum
    of |terms| with |ds| replaced by p (|dout| |v| + |dout| |out|) scale,
    which bounds dp and delta and so their rounding:
    * bfloat16: 2^-7 |y| + 2^-6 sqrt(sum t^2) + 2^-15 M (dq, dk) or
      2^-15 sum |t| (dv).  The first is a flip of the output's own
      rounding (one bf16 ulp, at most 2^-7 of it).  The second holds the
      flips of p's or ds's rounding (one ulp, at most 2^-7 of the term;
      rare, as the two f32 values before it differ in their last bits,
      and of either sign, so they add as a random walk) with a factor 2,
      and the f32 sums in another order (at most n 2^-24 sum |t|, which
      sqrt(sum t^2) >= sum |t| / sqrt(n) keeps below 2^-7 sqrt(sum t^2)
      for n <= 2^11).  The third holds where dp - delta cancels, so that
      ds moves by more than an ulp: dp and delta in f32 over D <= 256
      terms move by at most 2^-16 of their sums of |terms|, and the
      random walk of those roundings lies well inside it;
    * float32: 2^-16 M.  Sums in another order over D and over up to 2^11
      rows or keys (each rounding 2^-24 of a partial sum; JAX's and the
      plain version's gradients differ by at most 2^-19.7 M on the CPU
      tests' grid), then p's share of s's error, which exp passes on."""
    hkv = k.shape[1]
    p, mag, qf, kr, vr, do, of, scale = _magnitudes(
        q, k, v, out, lse, dout, causal, scale, q_offset)
    sums = lambda w, qq, kk: _sums(w, qq, kk, hkv)  # noqa: E731
    m_dq, m_dk = sums(mag, qf.abs(), kr.abs())
    if q.dtype != torch.bfloat16:
        a_dv = _group_sum(torch.matmul(p.transpose(-1, -2), do.abs()), hkv)
        return 2.0 ** -16 * m_dq, 2.0 ** -16 * m_dk, 2.0 ** -16 * a_dv
    pb = p.to(v.dtype).to(F32)
    dp = torch.matmul(do, vr.transpose(-1, -2))
    delta = (do * of).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).to(F32)
    y_dq, y_dk = sums(ds, qf, kr)
    w_dq, w_dk = sums(ds.square(), qf.square(), kr.square())
    y_dv = _group_sum(torch.matmul(pb.transpose(-1, -2), do), hkv)
    w_dv = _group_sum(torch.matmul(pb.square().transpose(-1, -2),
                                   do.square()), hkv)
    a_dv = _group_sum(torch.matmul(pb.transpose(-1, -2), do.abs()), hkv)
    return tuple(2.0 ** -7 * y.abs() + 2.0 ** -6 * w.sqrt() + 2.0 ** -15 * m
                 for y, w, m in ((y_dq, w_dq, m_dq), (y_dk, w_dk, m_dk),
                                 (y_dv, w_dv, a_dv)))


def tf32x3_bwd_bounds(q, k, v, out, lse, dout, *, causal: bool = True,
                      scale: float | None = None, q_offset: int = 0):
    """Elementwise bounds for a float32 backward whose scores come from
    3xTF32 products on ``mma.sync`` (the card's ``mma_tf32x3`` route), for
    a peaked softmax: :func:`attention_bwd_bounds` plus the share of the
    error of s that p passes on, which grows with the scores' size.

    With A = (|q| . |k|) scale, the size of s's terms:
    * the split: ``split_tf32`` gives x = hi + lo + r with |x - hi| <=
      2^-11 |x| (hi keeps 11 significant bits, rounded half away from
      zero) and |r| <= 2^-11 |x - hi| <= 2^-22 |x|; the three products lo_a
      hi_b + hi_a lo_b + hi_a hi_b leave out lo_a lo_b and the two r
      terms, each at most 2^-22 |a b|, so s is kept to 3 2^-22 A;
    * the sums: each of the 3 ceil(D / 8) ``mma.sync`` steps of s rounds
      its result toward zero (the tensor cores truncate), half an ulp of
      a partial sum (at most A) on average and of one sign where the
      partial sums keep theirs, as on the largest scores: 3 ceil(D / 8)
      2^-24 A.  Round to nearest (the FMA sums of the plain version and
      JAX) leaves a random walk, which the 2^-16 M of
      :func:`attention_bwd_bounds` holds where |s| is up to about 16.
    p = exp(s - lse) turns an error e A of s into e A p; through ds = p (dp
    - delta) scale, whose |p (dp - delta) scale| is at most mag (the weight
    behind M in :func:`attention_bwd_bounds`), ds moves by at most e A
    mag, so dq and dk by e sum A mag |k| and e sum A mag |q|, and dv by e
    sum A p |dout|.  The other errors of the route (dp's, and those of the
    products with ds and p) are shares of sums that M already bounds.  On
    a peaked softmax (q eight times larger, scores of tens) this share
    passes attention_bwd_bounds' 2^-16 M."""
    hkv, d = k.shape[1], q.shape[-1]
    base = attention_bwd_bounds(q, k, v, out, lse, dout, causal=causal,
                                scale=scale, q_offset=q_offset)
    p, mag, qf, kr, _, do, _, scale = _magnitudes(
        q, k, v, out, lse, dout, causal, scale, q_offset)
    a = torch.matmul(qf.abs(), kr.abs().transpose(-1, -2)) * scale
    e = 3 * 2.0 ** -22 + 3 * -(-d // 8) * 2.0 ** -24
    e_dq, e_dk = _sums(mag * a, qf.abs(), kr.abs(), hkv)
    e_dv = _group_sum(torch.matmul((p * a).transpose(-1, -2), do.abs()), hkv)
    return tuple(b + e * x for b, x in zip(base, (e_dq, e_dk, e_dv)))
