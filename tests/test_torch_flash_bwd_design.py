"""The arithmetic of the card's flash-attention backward, on the CPU.

``csrc/flash_attention_bwd.cu`` runs bfloat16 on ``mma.sync`` m16n8k16
and float32 in 3xTF32 on ``mma.sync`` m16n8k8, each in two kernels.
These tests emulate both routes in torch, in the kernels' summation
order, and hold the emulation against the plain version
(``attention_bwd_ref``) and against JAX's ``chunked_attention`` VJP on
the same numpy-seeded inputs, elementwise within
``attention_bwd_bounds`` (``tf32x3_bwd_bounds`` on a peaked softmax in
float32).  The bf16 route:

* the dQ kernel: delta = rowsum(dO * O), a lane's 8 columns summed in
  order and the 32 lanes by an xor butterfly; S = Q K^T and dP = dO V^T,
  one f32 sum of 16 products per k16 step over D, added in order; p =
  exp2(s scale log2e - lse log2e) (the two factors rounded to f32, one
  FMA); dS = p (dP - delta) scale, rounded to bf16 as an operand; dQ
  summed over the keys one k16 step at a time;
* the dK/dV kernel: S^T = K Q^T and dP^T = V dO^T the same way; p
  rounded to bf16 for dV; dV += P^T dO and dK += dS^T Q one k16 step of
  16 queries at a time, over the query heads of the group in order.
  Two warps split each q tile: each sums its half of every tile (32
  queries; 64 up to D 64) and the two sums are added at the end.

The float32 route (``emulate_bwd_tf32x3``) has the same two kernels'
order with k8 steps: every operand split into hi = tf32(x) and lo =
tf32(x - hi) (``cvt.rna``: half away from zero at bit 13), and each k8
step three products added to the f32 accumulator in turn, lo hi, hi lo,
hi hi (each product of eight terms exact, one rounding as it is added);
delta by FMA in column order; p = expf(fma(s, scale, -lse)); dS = p (dP
- delta) scale, unrounded; up to D 128 the dQ kernel's two warps of 16
rows take 16 keys each of every 32-key tile, and the dK/dV kernel's four
warps of 16 keys 16 queries each of every 64-query tile (from D 192, one
warp all 16 keys of a tile, and two warps 16 queries each of 32), the
warps' sums added in order at the end.

Tiles the kernels skip (keys no query of a warp sees, query rows before
a key tile's first visible row) add exact zeros, so the emulation sums
over every step.  D is padded with zeros to the kernel's DN.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    NEG_INF, attention_bwd_bounds, attention_bwd_ref, tf32x3_bwd_bounds)

F32 = torch.float32
BF16 = torch.bfloat16
LOG2E = np.float32(1.4426950408889634)
DNS = (16, 32, 64, 80, 96, 128, 192, 256)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even, as ``cvt.rn.bf16x2.f32``), as
    float32."""
    return x.to(BF16).to(F32)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """fmaf(a, b, c) in float32 (one rounding of the exact a b + c); b and
    c tensors or scalars."""
    f64 = lambda x: torch.as_tensor(x).double()  # noqa: E731
    return (f64(a) * f64(b) + f64(c)).to(F32)


def _steps(x: torch.Tensor, y: torch.Tensor, dim: int) -> torch.Tensor:
    """x @ y summed one k16 step at a time along the contracted axis
    (``dim`` of x's last axis length), each step's f32 sum added in
    order, as the accumulator of ``mma.sync``."""
    acc = torch.zeros(x.shape[:-1] + y.shape[-1:], dtype=F32)
    for c in range(0, dim, 16):
        acc = acc + x[..., c:c + 16] @ y[..., c:c + 16, :]
    return acc


def _butterfly_delta(out: torch.Tensor, dout: torch.Tensor, dn: int):
    """rowsum(dO * O) as the dQ kernel takes it: lane l sums columns 8 l
    .. 8 l + 7 in order by FMA (exact products for bf16 inputs), then
    ``acc += shfl_xor(acc, o)`` for o = 16, 8, 4, 2, 1; lane 0's sum."""
    pad = lambda x: torch.nn.functional.pad(  # noqa: E731
        x.to(F32), (0, 256 - x.shape[-1]))
    lanes = [pad(x).reshape(x.shape[:-1] + (32, 8)) for x in (out, dout)]
    acc = torch.zeros(lanes[0].shape[:-1], dtype=F32)
    for j in range(8):
        acc = _fma(lanes[0][..., j], lanes[1][..., j], acc)
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., idx ^ o]
    return acc[..., 0]


def emulate_bwd(q, k, v, out, lse, dout, *, causal, q_offset):
    """(dq, dk, dv) of the two mma kernels, emulated; bf16 inputs."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    dn = next(n for n in DNS if d <= n)
    scale = np.float32(1.0 / (d ** 0.5))
    sl2 = np.float32(scale * LOG2E)
    pad = lambda x: torch.nn.functional.pad(  # noqa: E731
        x.to(F32), (0, dn - d))
    qf, kf, vf, dof = pad(q), pad(k), pad(v), pad(dout)
    kr = kf.repeat_interleave(g, dim=1)
    vr = vf.repeat_interleave(g, dim=1)

    delta = _butterfly_delta(out, dout, dn)
    s = _steps(qf, kr.transpose(-1, -2), dn)
    dp = _steps(dof, vr.transpose(-1, -2), dn)
    row = torch.arange(sq)[:, None] + q_offset
    col = torch.arange(skv)[None, :]
    mask = (col <= row) if causal else torch.ones((sq, skv), dtype=bool)
    row_ok = lse > 0.5 * NEG_INF
    nl2 = (-lse * LOG2E).to(F32)
    p = torch.where(mask & row_ok[..., None],
                    torch.exp2(_fma(s, sl2, nl2[..., None])), 0.0)
    ds = p * (dp - delta[..., None]) * scale
    dq = _steps(_bf16(ds), kr, skv)[..., :d]

    # dK/dV: S^T and dP^T from their own products (K, V as A), then the
    # group's heads one after another.
    st = _steps(kr, qf.transpose(-1, -2), dn)
    dpt = _steps(vr, dof.transpose(-1, -2), dn)
    pt = torch.where((mask & row_ok[..., None]).transpose(-1, -2),
                     torch.exp2(_fma(st, sl2, nl2[..., None, :])), 0.0)
    dst = pt * (dpt - delta[..., None, :]) * scale
    pt, dst = _bf16(pt), _bf16(dst)
    wq = 64 if dn <= 64 else 32
    dk = torch.zeros((2, b, hkv, skv, dn), dtype=F32)
    dv = torch.zeros_like(dk)
    for gi in range(g):
        heads = slice(gi, hq, g)
        for c in range(0, sq, 16):
            w = c // wq % 2   # the warp whose half of the tile holds c
            dv[w] = dv[w] + pt[:, heads, :, c:c + 16] @ dof[:, heads,
                                                          c:c + 16]
            dk[w] = dk[w] + dst[:, heads, :, c:c + 16] @ qf[:, heads,
                                                          c:c + 16]
    dk, dv = dk[0] + dk[1], dv[0] + dv[1]
    return dq.to(BF16), dk[..., :d].to(BF16), dv[..., :d].to(BF16)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``tf32_rna`` rounds (``cvt.rna``): half
    away from zero at bit 13, on the int32 view of the bits."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(F32)


def _split(x: torch.Tensor):
    """``split_tf32``: (hi, lo) = (tf32(x), tf32(x - hi))."""
    hi = _tf32(x.contiguous())
    return hi, _tf32((x - hi).contiguous())


def _steps_tf32x3(x: torch.Tensor, y: torch.Tensor, acc=None):
    """acc + x @ y as ``mma_tf32x3`` sums it, one k8 step of the contracted
    axis at a time: lo hi, hi lo, then hi hi, each product of eight terms
    exact (TF32 factors) and added to the f32 accumulator with one
    rounding."""
    (x_hi, x_lo), (y_hi, y_lo) = _split(x), _split(y)
    if acc is None:
        acc = torch.zeros(x.shape[:-1] + y.shape[-1:], dtype=F32)
    for c in range(0, x.shape[-1], 8):
        for a, b in ((x_lo, y_hi), (x_hi, y_lo), (x_hi, y_hi)):
            acc = (acc.double() + a[..., c:c + 8].double()
                   @ b[..., c:c + 8, :].double()).to(F32)
    return acc


def _parts(n: int, width: int, ways: int) -> list:
    """Index tensors of [0, n) dealt to ``ways`` warps ``width`` at a
    time: warp w takes every i with i // width % ways == w."""
    return [torch.tensor([i for i in range(n) if i // width % ways == w],
                         dtype=torch.long) for w in range(ways)]


def emulate_bwd_tf32x3(q, k, v, out, lse, dout, *, causal, q_offset):
    """(dq, dk, dv) of the two 3xTF32 kernels, emulated; float32 inputs."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    dn = next(n for n in DNS if d <= n)
    scale = np.float32(1.0 / (d ** 0.5))
    pad = lambda x: torch.nn.functional.pad(  # noqa: E731
        x.to(F32), (0, dn - d))
    qf, kf, vf, dof = pad(q), pad(k), pad(v), pad(dout)
    kr = kf.repeat_interleave(g, dim=1)
    vr = vf.repeat_interleave(g, dim=1)
    row = torch.arange(sq)[:, None] + q_offset
    col = torch.arange(skv)[None, :]
    mask = (col <= row) if causal else torch.ones((sq, skv), dtype=bool)
    keep = mask & (lse > 0.5 * NEG_INF)[..., None]
    delta = _butterfly_delta(out, dout, dn)

    # dQ kernel: S = Q K^T, dP = dO V^T over D; dS; dQ += dS K over keys,
    # up to D 128 by two warps, each the keys of its half of every 32-key
    # tile, their sums added at the end.
    s = _steps_tf32x3(qf, kr.transpose(-1, -2))
    dp = _steps_tf32x3(dof, vr.transpose(-1, -2))
    p = torch.where(keep, torch.exp(_fma(s, scale, -lse[..., None])), 0.0)
    ds = p * (dp - delta[..., None]) * scale
    dq = None
    for keys in _parts(skv, 16, 2 if dn <= 128 else 1):
        x = _steps_tf32x3(ds[..., keys], kr[..., keys, :])
        dq = x if dq is None else dq + x
    dq = dq[..., :d]

    # dK/dV kernel: S^T = K Q^T, dP^T = V dO^T (K, V as A); then the
    # group's heads in turn, each warp of a key row group its 16 queries
    # of every q tile (4 warps to D 128, then 2), the sums added in order.
    st = _steps_tf32x3(kr, qf.transpose(-1, -2))
    dpt = _steps_tf32x3(vr, dof.transpose(-1, -2))
    pt = torch.where(keep.transpose(-1, -2),
                     torch.exp(_fma(st, scale, -lse[..., None, :])), 0.0)
    dst = pt * (dpt - delta[..., None, :]) * scale
    parts = _parts(sq, 16, 4 if dn <= 128 else 2)
    dk = torch.zeros((len(parts), b, hkv, skv, dn), dtype=F32)
    dv = torch.zeros_like(dk)
    for gi in range(g):
        heads = slice(gi, hq, g)
        for w, c in enumerate(parts):
            dv[w] = _steps_tf32x3(pt[:, heads][..., c],
                                  dof[:, heads][..., c, :], dv[w])
            dk[w] = _steps_tf32x3(dst[:, heads][..., c],
                                  qf[:, heads][..., c, :], dk[w])
    for w in range(1, len(parts)):
        dk[0], dv[0] = dk[0] + dk[w], dv[0] + dv[w]
    return dq, dk[0][..., :d], dv[0][..., :d]


# D 64, 80 and 128 (every model config's) and GQA 1, 2 and 4 after 71
# cached keys (Sq 40, Skv 111); a row without keys (q_offset -1); a
# full (non-causal) mask with Skv > Sq.
CASES = [(64, 1, 40, 111, True, 71), (80, 2, 40, 111, True, 71),
         (128, 4, 40, 111, True, 71), (128, 2, 40, 111, True, 71),
         (80, 2, 33, 33, True, -1), (64, 4, 24, 70, False, 0)]


def _inputs(d, g, sq, skv, causal, q_offset, dtype=jnp.bfloat16,
            q_factor=1.0):
    """q (times ``q_factor``), k, v, dout of ``dtype`` from numpy
    (seeded), JAX's forward (out, lse) and its VJP (dq, dk, dv) on them;
    torch tensors of the same type."""
    rng = np.random.default_rng(1000 * d + 10 * g + sq)
    hkv = 2
    shapes = ((1, hkv * g, sq, d), (1, hkv, skv, d), (1, hkv, skv, d),
              (1, hkv * g, sq, d))
    q, k, v, do = (jnp.asarray(rng.standard_normal(sh).astype(np.float32)
                               * (q_factor if i == 0 else 1.0), dtype)
                   for i, sh in enumerate(shapes))
    kw = dict(causal=causal, q_chunk=16, kv_chunk=16, q_offset=q_offset)
    out, lse = jattn._chunked_attention_fwd(q, k, v, window=0, **kw)
    _, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention(
        a, b, c, recompute_bwd=True, **kw), q, k, v)
    to = getattr(torch, jnp.dtype(dtype).name)
    tt = lambda x: torch.as_tensor(  # noqa: E731
        np.asarray(x, np.float32)).to(to)
    args = (tt(q), tt(k), tt(v), tt(out),
            torch.as_tensor(np.array(lse)).reshape(1, hkv * g, sq), tt(do))
    want_jax = tuple(torch.as_tensor(np.asarray(x, np.float32))
                     for x in vjp(do))
    return args, want_jax


def _hold(got, args, want_jax, bounds, kw):
    """got against the plain version and JAX's VJP, elementwise within
    ``bounds``; the largest err / bound of each output."""
    plain = attention_bwd_ref(*args, **kw)
    ratios = []
    for name, x, w_plain, w_jax, bound in zip(
            ("dq", "dk", "dv"), got, plain, want_jax, bounds):
        assert x.dtype == w_plain.dtype and x.shape == w_plain.shape
        for label, w in (("plain", w_plain.float()), ("jax", w_jax)):
            err = (x.float() - w).abs()
            assert bool((err <= bound).all()), (
                f"{name} against {label}: max err {float(err.max())}, "
                f"bound there {float(bound.flatten()[err.argmax()])}")
            ratios.append(float((err / bound).max()))
    if kw["q_offset"] < 0:   # the row without keys gets no gradient
        assert not got[0][:, :, 0].any()
    return ratios


@pytest.mark.parametrize("d,g,sq,skv,causal,q_offset", CASES)
def test_mma_design_matches_plain_and_jax(d, g, sq, skv, causal, q_offset):
    args, want_jax = _inputs(d, g, sq, skv, causal, q_offset)
    kw = dict(causal=causal, q_offset=q_offset)
    _hold(emulate_bwd(*args, **kw), args, want_jax,
          attention_bwd_bounds(*args, **kw), kw)


@pytest.mark.parametrize("d,g,sq,skv,causal,q_offset", CASES)
def test_tf32x3_design_matches_plain_and_jax(d, g, sq, skv, causal,
                                             q_offset):
    """The float32 route within the float32 ``attention_bwd_bounds``
    (2^-16 M) as it stands: at these scores 3xTF32's error of s stays
    inside it."""
    args, want_jax = _inputs(d, g, sq, skv, causal, q_offset, jnp.float32)
    kw = dict(causal=causal, q_offset=q_offset)
    got = emulate_bwd_tf32x3(*args, **kw)
    assert all(x.dtype == torch.float32 for x in got)
    _hold(got, args, want_jax, attention_bwd_bounds(*args, **kw), kw)


def test_tf32x3_design_on_a_peaked_softmax():
    """q eight times larger (scores of tens, GQA 2 after 71 keys, D 128):
    the float32 route within ``tf32x3_bwd_bounds``, which adds to
    ``attention_bwd_bounds`` 2^-20 of each output's sum weighted by the
    scores' size (3xTF32's error of s, which p passes on)."""
    case = (128, 2, 40, 111, True, 71)
    args, want_jax = _inputs(*case, jnp.float32, q_factor=8.0)
    kw = dict(causal=True, q_offset=71)
    _hold(emulate_bwd_tf32x3(*args, **kw), args, want_jax,
          tf32x3_bwd_bounds(*args, **kw), kw)


def test_emulated_p_is_the_plain_p_to_a_few_ulp():
    """p by exp2 with the log2e prescale (one FMA, then ``exp2``) against
    the exact exp(s scale - lse): within 2^-18 relative where |s scale -
    lse| <= 16.  The log2-domain argument (at most 23 in size) takes
    three f32 roundings (scale log2e, lse log2e, the FMA), 2^-24 of it
    each, and exp2 turns an absolute error e into a relative one of e ln
    2: far inside the bf16 rounding of p that follows (2^-9)."""
    rng = np.random.default_rng(3)
    s = torch.as_tensor(rng.standard_normal(4096).astype(np.float32) * 40)
    lse = torch.as_tensor(rng.standard_normal(4096).astype(np.float32) * 4)
    scale = np.float32(1 / np.sqrt(128))
    keep = (s.double() * float(scale) - lse.double()).abs() <= 16
    got = torch.exp2(_fma(s, np.float32(scale * LOG2E),
                          (-lse * LOG2E).to(F32)))
    want = torch.exp(s.double() * float(scale) - lse.double())
    rel = ((got.double() - want) / want).abs()[keep]
    assert int(keep.sum()) > 3000 and float(rel.max()) < 2.0 ** -18
