"""The arithmetic of the card's bf16 flash-attention backward, on the CPU.

``csrc/flash_attention_bwd.cu`` runs bfloat16 on ``mma.sync`` m16n8k16
in two kernels.  These tests emulate both in torch, in the kernels'
summation order, and hold the emulation against the plain version
(``attention_bwd_ref``) and against JAX's ``chunked_attention`` VJP on
the same numpy-seeded inputs, elementwise within
``attention_bwd_bounds``:

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

Tiles the kernels skip (keys no query of a warp sees, query rows before
a key tile's first visible row) add exact zeros, so the emulation sums
over every step.  The inputs are bf16; D is padded with zeros to the
kernel's DN.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    NEG_INF, attention_bwd_bounds, attention_bwd_ref)

F32 = torch.float32
BF16 = torch.bfloat16
LOG2E = np.float32(1.4426950408889634)
DNS = (16, 32, 64, 80, 96, 128, 192, 256)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even, as ``cvt.rn.bf16x2.f32``), as
    float32."""
    return x.to(BF16).to(F32)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """fmaf(a, b, c) in float32 (one rounding of the exact a b + c)."""
    return (a.double() * float(b) + c.double()).to(F32)


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
    .. 8 l + 7 in order, then ``acc += shfl_xor(acc, o)`` for o = 16, 8,
    4, 2, 1; lane 0's sum."""
    prod = out.to(F32) * dout.to(F32)
    prod = torch.nn.functional.pad(prod, (0, 256 - prod.shape[-1]))
    lanes = prod.reshape(prod.shape[:-1] + (32, 8))
    acc = torch.zeros(lanes.shape[:-1], dtype=F32)
    for j in range(8):
        acc = acc + lanes[..., j]
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


# D 64, 80 and 128 (every model config's) and GQA 1, 2 and 4 after 71
# cached keys (Sq 40, Skv 111); a row without keys (q_offset -1); a
# full (non-causal) mask with Skv > Sq.
CASES = [(64, 1, 40, 111, True, 71), (80, 2, 40, 111, True, 71),
         (128, 4, 40, 111, True, 71), (128, 2, 40, 111, True, 71),
         (80, 2, 33, 33, True, -1), (64, 4, 24, 70, False, 0)]


def _inputs(d, g, sq, skv, causal, q_offset):
    """bf16 q, k, v, dout from numpy (seeded), JAX's forward (out, lse)
    and its VJP (dq, dk, dv) on them."""
    rng = np.random.default_rng(1000 * d + 10 * g + sq)
    hkv = 2
    shapes = ((1, hkv * g, sq, d), (1, hkv, skv, d), (1, hkv, skv, d),
              (1, hkv * g, sq, d))
    q, k, v, do = (jnp.asarray(rng.standard_normal(sh).astype(np.float32),
                               jnp.bfloat16) for sh in shapes)
    kw = dict(causal=causal, q_chunk=16, kv_chunk=16, q_offset=q_offset)
    out, lse = jattn._chunked_attention_fwd(q, k, v, window=0, **kw)
    _, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention(
        a, b, c, recompute_bwd=True, **kw), q, k, v)
    tt = lambda x: torch.as_tensor(  # noqa: E731
        np.asarray(x, np.float32)).to(BF16)
    args = (tt(q), tt(k), tt(v), tt(out),
            torch.as_tensor(np.array(lse)).reshape(1, hkv * g, sq), tt(do))
    want_jax = tuple(torch.as_tensor(np.asarray(x, np.float32))
                     for x in vjp(do))
    return args, want_jax


@pytest.mark.parametrize("d,g,sq,skv,causal,q_offset", CASES)
def test_mma_design_matches_plain_and_jax(d, g, sq, skv, causal, q_offset):
    args, want_jax = _inputs(d, g, sq, skv, causal, q_offset)
    kw = dict(causal=causal, q_offset=q_offset)
    plain = attention_bwd_ref(*args, **kw)
    bounds = attention_bwd_bounds(*args, **kw)
    got = emulate_bwd(*args, **kw)
    for name, x, w_plain, w_jax, bound in zip(
            ("dq", "dk", "dv"), got, plain, want_jax, bounds):
        assert x.dtype == w_plain.dtype and x.shape == w_plain.shape
        for label, w in (("plain", w_plain.float()), ("jax", w_jax)):
            err = (x.float() - w).abs()
            assert bool((err <= bound).all()), (
                f"{name} against {label}: max err {float(err.max())}, "
                f"bound there {float(bound.flatten()[err.argmax()])}")
    if q_offset < 0:   # the row without keys gets no gradient
        assert not got[0][:, :, 0].any()


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
