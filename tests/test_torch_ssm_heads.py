"""Port parity, the scan's backward for Mamba-2's per-head decay: the
chunked plain version (``ssm_scan_heads_bwd_ref``), the ``SSMScanHeads``
autograd Function on the CPU, and the arithmetic of the chunked kernel
(``csrc/ssm_scan_bwd_chunked.cu``: every product in 3xTF32).

Inputs come from numpy with a seed.  Tolerances, each with its reason:
* against ``ssm_scan_bwd_ref`` (the per-channel reverse-time loop, ddt
  summed over each head's channels and dA over its channels and states),
  run in float64 so that only the chunked version's float32 rounding
  shows: every gradient of the float32 chunked version within 1e-5 of
  its largest |.| (float32 sums in another order; da_h, a sum of terms
  that cancel, comes closest, at 6.8e-6 of its largest at worst over
  five seeds of each of these shapes); the float64 runs of the two forms
  within 1e-12 of each other (the same algebra);
* a bf16 x: dx within one bf16 ulp (2^-7 |dx|) besides the 1e-5, as both
  sides round a float32 dx to bf16 and may round apart;
* against ``jax.vjp`` of the reference's ``scan_chunked`` through its own
  broadcasts (``jnp.repeat(dt_h, P)``, ``jnp.repeat(a_h, P)[:, None] *
  ones``): as ``tests/test_torch_ssm_bwd.py``, 1e-5 of each gradient's
  largest, a bf16 dx also within one bf16 rounding (2^-8 |dx|) of JAX's
  float32 gradient;
* the kernel's products emulated on one 64 x 64 x 64 chunk: 3xTF32
  within 1e-5 of each output's largest against float64 (a tenth of the
  card's 1e-4), one TF32 product beyond 1e-4;
* ``SSMScanHeads`` against autograd through ``ssm_scan_ref`` of the
  broadcast inputs: 1e-5 of the largest |.|.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as scan  # noqa: E402
from repro_torch.kernels.ssm_scan import ref  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import (  # noqa: E402
    heads_to_channels, ssm_scan_bwd_ref, ssm_scan_heads_bwd_ref,
    ssm_scan_ref, ssm_scan_with_states_ref)

NAMES = ("dx", "ddt_h", "da_h", "dB", "dC", "dD")
F32, F64 = torch.float32, torch.float64


def _inputs(b, t, nh, p, n, seed):
    """numpy float32 (x, dt_h, a_h, B, C, D, dy, dh): dt_h from softplus,
    a_h negative, one per head of ``p`` channels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, nh * p))
    dt_h = np.log1p(np.exp(rng.standard_normal((b, t, nh)) - 1.0))
    a_h = -np.exp(rng.standard_normal(nh) * 0.5)
    rest = (rng.standard_normal((b, t, n)), rng.standard_normal((b, t, n)),
            rng.standard_normal(nh * p), rng.standard_normal((b, t, nh * p)),
            rng.standard_normal((b, nh * p, n)))
    return [z.astype(np.float32) for z in (x, dt_h, a_h) + rest]


def _close(name, got, want, ulp=0.0):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=ulp,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=name)


def _per_head(grads, b, t, nh, p, n):
    """``ssm_scan_bwd_ref``'s gradients with ddt summed over each head's
    channels and dA over its channels and states."""
    dx, ddt, da, db, dc, dd = grads
    return (dx, ddt.view(b, t, nh, p).sum(-1), da.view(nh, p, n).sum((1, 2)),
            db, dc, dd)


CASES = [
    # (b, t, heads, P, N, dh given, x bf16)
    (2, 1, 2, 8, 8, True, False),
    (1, 63, 3, 16, 32, False, False),
    (2, 64, 2, 64, 64, True, False),
    (1, 65, 3, 8, 16, True, True),
    (2, 130, 2, 32, 8, False, False),
    (1, 130, 3, 64, 64, True, True),
]


@pytest.mark.parametrize("b,t,nh,p,n,with_dh,bf16", CASES)
def test_chunked_bwd_matches_the_per_channel_loop(monkeypatch, b, t, nh, p,
                                                  n, with_dh, bf16):
    x, dt_h, a_h, bm, cm, d, dy, dh = (torch.tensor(z) for z in _inputs(
        b, t, nh, p, n, t + nh * p + n))
    x = x.to(torch.bfloat16) if bf16 else x
    dh = dh if with_dh else None
    dt, a = heads_to_channels(dt_h, a_h, p, n)
    _, _, hc = ssm_scan_with_states_ref(x, dt, a, bm, cm, d)
    got = ssm_scan_heads_bwd_ref(x, dt_h, a_h, bm, cm, d, hc, dy, dh)
    assert got[0].dtype == x.dtype
    assert all(g.dtype == F32 for g in got[1:])
    assert tuple(got[1].shape) == (b, t, nh) and tuple(got[2].shape) == (nh,)
    # Both forms in float64 (every float32 inside the plain versions).
    monkeypatch.setattr(ref, "F32", F64)
    d64 = lambda z: None if z is None else z.double()  # noqa: E731
    _, _, hc64 = ssm_scan_with_states_ref(*map(d64, (x, dt, a, bm, cm, d)))
    args64 = [d64(z) for z in (x, dt_h, a_h, bm, cm, d, hc64, dy, dh)]
    want = _per_head(ssm_scan_bwd_ref(*map(d64, (x, dt, a, bm, cm, d, hc64,
                                                 dy)), d64(dh)),
                     b, t, nh, p, n)
    exact = ssm_scan_heads_bwd_ref(*args64)
    for name, g, e, w in zip(NAMES, got, exact, want):
        np.testing.assert_allclose(e.numpy(), w.numpy(), rtol=0,
                                   atol=1e-12 * float(w.abs().max()),
                                   err_msg=name)
        _close(name, g, w.numpy(),
               ulp=2**-7 if (bf16 and name == "dx") else 0.0)


def _jax_grads(x, dt_h, a_h, bm, cm, d, dy, dh):
    """``jax.vjp`` of ``scan_chunked`` (h0 = 0, one step a ``lax.scan``
    tick) through the reference's broadcasts of dt_h and a_h, with
    cotangents dy and dh (0 where None)."""
    b, _, di = x.shape
    nh, n = a_h.shape[0], bm.shape[-1]
    p = di // nh
    h0 = jnp.zeros((b, di, n), jnp.float32)

    def fn(x, dt_h, a_h, bm, cm, d):
        dt = jnp.repeat(dt_h, p, axis=-1)
        a = jnp.repeat(a_h, p)[:, None] * jnp.ones((1, n), jnp.float32)
        return jssm.scan_chunked(x, dt, a, bm, cm, d, h0, unroll=1)

    (y, h), vjp = jax.vjp(fn, *(jnp.asarray(z) for z in (x, dt_h, a_h, bm,
                                                          cm, d)))
    ct_h = jnp.zeros_like(h) if dh is None else jnp.asarray(dh)
    return vjp((jnp.asarray(dy), ct_h))


@pytest.mark.parametrize("b,t,nh,p,n,with_dh,bf16", [
    (2, 37, 2, 16, 8, True, False),
    (1, 130, 2, 64, 16, False, False),
    (2, 70, 3, 8, 16, True, True)])
def test_chunked_bwd_matches_jax_vjp_through_the_broadcasts(b, t, nh, p, n,
                                                            with_dh, bf16):
    x, dt_h, a_h, bm, cm, d, dy, dh = _inputs(b, t, nh, p, n, 5 + t)
    dh = dh if with_dh else None
    x_t = torch.tensor(x).to(torch.bfloat16) if bf16 else torch.tensor(x)
    want = _jax_grads(x_t.float().numpy(), dt_h, a_h, bm, cm, d, dy, dh)
    rest = [torch.tensor(z) for z in (dt_h, a_h, bm, cm, d)]
    dt, a = heads_to_channels(rest[0], rest[1], p, n)
    _, _, hc = ssm_scan_with_states_ref(x_t, dt, a, *rest[2:])
    got = ssm_scan_heads_bwd_ref(x_t, *rest, hc, torch.tensor(dy),
                                 None if dh is None else torch.tensor(dh))
    for name, g, w in zip(NAMES, got, want):
        _close(name, g.float(), w,
               ulp=2**-8 if (bf16 and name == "dx") else 0.0)


# ---------------------------------------------------------------------------
# The kernel's arithmetic: one chunk's products in 3xTF32
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``tf32_rna`` rounds (``cvt.rna``): half
    away from zero at bit 13, on the int32 view of the bits."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(F32)


def _mm(terms: int):
    """a @ b as ``mma_tf32x3`` (terms 3: lo hi + hi lo + hi hi, hi =
    tf32(x), lo = tf32(x - hi)) or one TF32 product (terms 1) sums it,
    the products in float64 and the result in float32; terms 0: exact,
    in float64."""
    def mm(a, b):
        if terms == 0:
            return a.double() @ b.double()
        a, b = a.float(), b.float()
        a_hi, b_hi = _tf32(a), _tf32(b)
        out = a_hi.double() @ b_hi.double()
        if terms == 3:
            a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
            out = a_lo.double() @ b_hi.double() + (
                a_hi.double() @ b_lo.double() + out)
        return out.float()
    return mm


def _chunk_bwd(mm, x, dt, a, bm, cm, d, h0, g, dy):
    """One (chunk, head) of the kernel, its products through ``mm`` as the
    kernel forms them: a row or column scale (w, exp(cum), dt) goes on a
    product's sums where it scales an output index, and on an operand
    only where its index is summed over (exp(cum) in the end-state
    product); M and dM~ are masked and scaled elementwise before they are
    operands; ds as the kernel sums it: (dx, ddt, da, dB, dC, dD, G of the
    chunk before)."""
    q = x.shape[0]
    cum = torch.cumsum(dt * a, 0)
    tri = torch.ones((q, q), dtype=torch.bool).tril()
    ell = torch.exp((cum[:, None] - cum[None]).masked_fill(~tri,
                                                           float("-inf")))
    ecum, w = torch.exp(cum), torch.exp(cum[-1] - cum)
    u = dt[:, None] * x
    cb = mm(cm, bm.T)
    m = cb * ell
    f = w[:, None] * mm(bm, g.T)
    du = mm(m.T, dy) + f
    dmt = mm(dy, x.T) * dt[None] * ell
    z = dmt * cb
    e = ecum[:, None] * mm(dy, h0)
    dc = e + mm(dmt, bm)
    db = mm(dmt.T, cm) + (w * dt)[:, None] * mm(x, g)
    rr = (u * f).sum(1)
    dcum = z.sum(1) - z.sum(0) + (e * cm).sum(1) - rr
    dcum[-1] += rr.sum() + ecum[-1] * (g * h0).sum()
    ds = dcum.flip(0).cumsum(0).flip(0)
    return (du * dt[:, None] + dy * d, a * ds + (du * x).sum(1),
            (ds * dt).sum(), db, dc, (dy * x).sum(0),
            ecum[-1] * g + mm((ecum[:, None] * dy).T, cm))


def test_chunk_products_need_three_tf32_products():
    rng = np.random.default_rng(11)
    q = p = n = 64
    t = lambda *s: torch.tensor(rng.standard_normal(s),  # noqa: E731
                                dtype=F32)
    x, bm, cm, h0, g, dy, d = (t(q, p), t(q, n), t(q, n), t(p, n), t(p, n),
                               t(q, p), t(p))
    dt = torch.nn.functional.softplus(t(q) - 1.0)
    a = torch.tensor(-np.exp(0.5 * rng.standard_normal()), dtype=F32)
    args = (x, dt, a, bm, cm, d, h0, g, dy)
    exact = _chunk_bwd(_mm(0), *(z.double() for z in args))
    err = {}
    for terms in (3, 1):
        got = _chunk_bwd(_mm(terms), *args)
        err[terms] = [float((gv.double() - e).abs().max() / e.abs().max())
                      for gv, e in zip(got, exact)]
    assert max(err[3]) < 1e-5, err[3]
    assert max(err[1]) > 1e-4, err[1]


# ---------------------------------------------------------------------------
# The autograd Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_h", [False, True])
def test_scan_heads_function_matches_autograd_on_the_cpu(use_h):
    """``ssm_scan_heads`` with inputs that require grad goes through
    ``SSMScanHeads`` (the plain forward with checkpoints, then the chunked
    plain backward); its outputs are the plain scan's of the broadcast
    inputs bitwise, its gradients autograd's through ``ssm_scan_ref`` of
    ``heads_to_channels`` within 1e-5 of the largest |.|; under no_grad
    it is the forward alone."""
    b, t, nh, p, n = 2, 70, 3, 8, 16
    arrs = _inputs(b, t, nh, p, n, 3)
    dy, dh = torch.tensor(arrs[6]), torch.tensor(arrs[7])

    def plain(x, dt_h, a_h, bm, cm, d):
        dt, a = heads_to_channels(dt_h, a_h, p, n)
        return ssm_scan_ref(x, dt, a, bm, cm, d)

    grads = {}
    for label, fn in (("fn", scan.ssm_scan_heads), ("ref", plain)):
        leaves = [torch.tensor(z).requires_grad_(True) for z in arrs[:6]]
        y, h = fn(*leaves)
        loss = (y * dy).sum() + ((h * dh).sum() if use_h else 0.0)
        grads[label] = (y.detach(), h.detach(),
                        torch.autograd.grad(loss, leaves))
    (y, h, got), (wy, wh, want) = grads["fn"], grads["ref"]
    assert torch.equal(y, wy) and torch.equal(h, wh)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        _close(name, g, w.numpy())
    with torch.no_grad():
        out = scan.ssm_scan_heads(*(torch.tensor(z) for z in arrs[:6]))
    assert torch.equal(out[0], wy) and out[0].grad_fn is None
