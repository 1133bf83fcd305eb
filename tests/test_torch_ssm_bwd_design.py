"""The algebra of the card's general-A scan backward in its chunk form
(``csrc/ssm_scan_bwd.cu``, ``ssm_scan_bwd_chunks``), on the CPU.

The chunk form splits g = dL/dh at the forward's checkpoints (every
``CHUNK`` = 64 steps).  Within chunk c (steps t0 .. t1 - 1) g is the
chunk's own part, walked back from a zero carry, plus the carry K_c =
e_{t1} g_{t1} passed back through the chunk's decays e = exp(dt A):

    K_{last} = dh_T (0 if None),   K_{c-1} = L_c + M_c K_c,
    L_c = sum_{t0 <= s < t1} (prod_{t0 <= r <= s} e_r) C_s dy_s,
    M_c = exp(A sum_{t0 <= s < t1} dt_s).

``emulate_chunk_form`` does what the two kernels do, in torch: the carry
kernel's summaries (a forward pass per chunk from P = 1, P *= e, L += P C
dy, and the sum of dt), the chunk kernel's fold of the summaries after
its chunk from the last, and its walk of the chunk back from g = K_c,
the states recomputed from the checkpoint (never by dividing by e,
which underflows where dt A is very negative).  It is held against
``ssm_scan_bwd_ref`` and against ``jax.vjp`` of the JAX package's
``scan_chunked`` within the kernel's tolerance, 1e-4 of each gradient's
largest |.|: float32 sums in another order (the carry's products and
folds, the channel and state sums, the time sums of dA and dD).

The kernels take every exponential as 2^(dt (A log2 e)) by
``ex2.approx.ftz`` (a result below 2^-126 flushed to 0), A scaled once
(``kExp2``), and sum_n q A as sum_n q (A log2 e) times ln 2; so does
the emulation (``exp2=True``, the default), and with ``exp2=False`` it
takes the accurate exp: the two are held to each other and to the plain
backward within that bound.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as scan  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import (  # noqa: E402
    CHUNK, ssm_scan_bwd_ref, ssm_scan_with_states_ref)

F32 = torch.float32
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")
LOG2E = torch.tensor(1.4426950408889634, dtype=F32)
LN2 = torch.tensor(0.6931471805599453, dtype=F32)


def decays(dt, A, exp2):
    """exp(dt A) for dt [..., di] and A [di, N]: 2^(dt (A log2 e)), A
    scaled in float32 and a result below 2^-126 flushed to 0 as
    ``ex2.approx.ftz`` flushes it (``exp2``), or the accurate exp."""
    if exp2:
        e = torch.exp2(dt[..., None] * (A * LOG2E))
        return torch.where(e < 2.0**-126, torch.zeros_like(e), e)
    return torch.exp(dt[..., None] * A)


def carry_summaries(dt, A, Cm, dy, exp2=True):
    """The carry kernel: (L [B, chunks, di, N], the chunks' sums of dt [B,
    chunks, di]) for chunks 1 .. (chunk 0's are never read, left 0)."""
    b, t, di = dt.shape
    n, nc = A.shape[1], -(-t // CHUNK)
    ell = torch.zeros((b, nc, di, n), dtype=F32)
    sdt = torch.zeros((b, nc, di), dtype=F32)
    for c in range(1, nc):
        p = torch.ones((b, di, n), dtype=F32)
        for i in range(c * CHUNK, min(t, (c + 1) * CHUNK)):
            p = p * decays(dt[:, i], A, exp2)
            ell[:, c] += p * (Cm[:, i, None, :] * dy[:, i, :, None])
            sdt[:, c] += dt[:, i]
    return ell, sdt


def fold(ell, sdt, A, c, dh, exp2=True):
    """g at chunk c's end, K_c: dh (or 0) folded with the summaries of
    the chunks after c, from the last."""
    b, nc, di, n = ell.shape
    k = torch.zeros((b, di, n), dtype=F32) if dh is None else dh.clone()
    for kk in range(nc - 1, c, -1):
        k = decays(sdt[:, kk], A, exp2) * k + ell[:, kk]
    return k


def emulate_chunk_form(x, dt, A, Bm, Cm, D, h_chunks, dy, dh=None,
                       exp2=True):
    """The chunk form's gradients ``(dx, ddt, dA, dB, dC, dD)``, each chunk
    walked on its own from its checkpoint and its folded carry; dA and dD
    summed per chunk and then over the chunks, as the wrapper sums the
    kernel's partial sums."""
    x_type = x.dtype
    x, dt, A, Bm, Cm, D, dy = (z.to(F32) for z in (x, dt, A, Bm, Cm, D, dy))
    dh = None if dh is None else dh.to(F32)
    b, t, di = x.shape
    nc = -(-t // CHUNK)
    ell, sdt = carry_summaries(dt, A, Cm, dy, exp2)
    dx, ddt = torch.zeros_like(x), torch.zeros_like(x)
    dB, dC = torch.zeros_like(Bm), torch.zeros_like(Cm)
    dA_parts, dD_parts = [], []
    for c in range(nc):
        t0, t1 = c * CHUNK, min(t, (c + 1) * CHUNK)
        h = h_chunks[:, c].to(F32)
        hs, es = [], []
        for i in range(t0, t1):
            e = decays(dt[:, i], A, exp2)
            hs.append(h)
            es.append(e)
            h = e * h + (dt[:, i] * x[:, i])[:, :, None] * Bm[:, i, None, :]
        g, e_next, h_cur = fold(ell, sdt, A, c, dh, exp2), 1.0, h
        dA_c = torch.zeros_like(A)
        dD_c = torch.zeros((di,), dtype=F32)
        for i in reversed(range(t0, t1)):
            h_prev, e = hs[i - t0], es[i - t0]
            g = e_next * g + Cm[:, i, None, :] * dy[:, i, :, None]
            q = g * h_prev * e
            du = (g * Bm[:, i, None, :]).sum(-1)
            dB[:, i] = (g * (dt[:, i] * x[:, i])[:, :, None]).sum(1)
            dC[:, i] = (h_cur * dy[:, i, :, None]).sum(1)
            qa = ((q * (A * LOG2E)).sum(-1) * LN2 if exp2
                  else (q * A).sum(-1))
            ddt[:, i] = du * x[:, i] + qa
            dx[:, i] = du * dt[:, i] + dy[:, i] * D
            dA_c += (q * dt[:, i, :, None]).sum(0)
            dD_c += (dy[:, i] * x[:, i]).sum(0)
            e_next, h_cur = e, h_prev
        dA_parts.append(dA_c)
        dD_parts.append(dD_c)
    dA = torch.stack(dA_parts).sum(0) if nc else torch.zeros_like(A)
    dD = torch.stack(dD_parts).sum(0) if nc else torch.zeros_like(D)
    return dx.to(x_type), ddt, dA, dB, dC, dD


def _inputs(b, t, di, n, kind, seed, dt_scale=1.0, head=8):
    """numpy (x, dt, A, B, C, D, dy, dh) float32; A general, per head of
    ``head`` channels, or mixed (per head at even channels, general at
    odd ones); dt from softplus, times ``dt_scale``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, di))
    dt = np.log1p(np.exp(rng.standard_normal((b, t, di)) - 1.0)) * dt_scale
    general = -np.exp(rng.standard_normal((di, n)) * 0.5)
    a_h = -np.exp(rng.standard_normal(-(-di // head)) * 0.5)
    per_head = np.repeat(a_h, head)[:di, None] * np.ones((1, n))
    a = {"general": general, "per_head": per_head,
         "mixed": np.where((np.arange(di) % 2 == 0)[:, None], per_head,
                           general)}[kind]
    rest = (rng.standard_normal((b, t, n)), rng.standard_normal((b, t, n)),
            rng.standard_normal(di), rng.standard_normal((b, t, di)),
            rng.standard_normal((b, di, n)))
    return [z.astype(np.float32) for z in (x, dt, a) + rest]


def _jax_grads(x, dt, a, bm, cm, d, dy, dh):
    """``jax.vjp`` of ``scan_chunked`` (h0 = 0) with cotangents dy and dh
    (0 where None)."""
    b, _, di = x.shape
    h0 = jnp.zeros((b, di, a.shape[1]), jnp.float32)
    primals = tuple(jnp.asarray(z) for z in (x, dt, a, bm, cm, d))
    (_, h), vjp = jax.vjp(
        lambda *p: jssm.scan_chunked(*p, h0, unroll=1), *primals)
    ct_h = jnp.zeros_like(h) if dh is None else jnp.asarray(dh)
    return vjp((jnp.asarray(dy), ct_h))


def _close(name, got, want, tol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=name)


CASES = [
    # (b, t, di, n, A, dh given)
    (2, 130, 12, 16, "mixed", True),     # two whole chunks and a ragged one
    (2, 130, 12, 16, "general", False),
    (1, 40, 10, 8, "mixed", True),       # one chunk: no carry
    (2, 40, 6, 5, "general", False),     # N not a multiple of 4
    (1, 192, 8, 4, "per_head", True),    # three whole chunks
]


@pytest.mark.parametrize("b,t,di,n,kind,with_dh", CASES)
def test_chunk_form_matches_the_plain_backward_and_jax(b, t, di, n, kind,
                                                       with_dh):
    x, dt, a, bm, cm, d, dy, dh = _inputs(b, t, di, n, kind, t + di + n)
    dh = dh if with_dh else None
    tx = [torch.tensor(z) for z in (x, dt, a, bm, cm, d)]
    _, _, hc = ssm_scan_with_states_ref(*tx)
    tdy = torch.tensor(dy)
    tdh = None if dh is None else torch.tensor(dh)
    got = emulate_chunk_form(*tx, hc, tdy, tdh)
    plain = ssm_scan_bwd_ref(*tx, hc, tdy, tdh)
    jax_grads = _jax_grads(x, dt, a, bm, cm, d, dy, dh)
    for name, g, p, j in zip(NAMES, got, plain, jax_grads):
        _close(name, g.numpy(), p.numpy())
        _close(name, g.numpy(), j)


def test_carry_folds_through_decays_that_underflow():
    """dt 60 times softplus: many decays of a chunk underflow to 0 in
    float32, so the summaries carry nothing back past them; the fold
    multiplies by M_c = 0 and never divides, and the gradients still
    match the plain backward."""
    x, dt, a, bm, cm, d, dy, dh = _inputs(1, 130, 6, 8, "general", 3,
                                          dt_scale=60.0)
    tx = [torch.tensor(z) for z in (x, dt, a, bm, cm, d)]
    _, sdt = carry_summaries(tx[1], tx[2], tx[4], torch.tensor(dy))
    assert bool((torch.exp(sdt[:, 1:, :, None] * tx[2]) == 0).any())
    _, _, hc = ssm_scan_with_states_ref(*tx)
    got = emulate_chunk_form(*tx, hc, torch.tensor(dy), torch.tensor(dh))
    want = ssm_scan_bwd_ref(*tx, hc, torch.tensor(dy), torch.tensor(dh))
    for name, g, w in zip(NAMES, got, want):
        assert bool(torch.isfinite(g).all()), name
        _close(name, g.numpy(), w.numpy())


@pytest.mark.parametrize("t", [0, 64, 65])
def test_chunk_edges(t):
    """T at and just past a chunk's end (a carry from a one-step chunk),
    and T 0 (no chunk: every gradient 0 or empty)."""
    x, dt, a, bm, cm, d, dy, dh = _inputs(1, t, 4, 8, "mixed", 11 + t)
    tx = [torch.tensor(z) for z in (x, dt, a, bm, cm, d)]
    _, _, hc = ssm_scan_with_states_ref(*tx)
    got = emulate_chunk_form(*tx, hc, torch.tensor(dy), torch.tensor(dh))
    want = ssm_scan_bwd_ref(*tx, hc, torch.tensor(dy), torch.tensor(dh))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        if w.numel():
            _close(name, g.numpy(), w.numpy())


def test_the_route_splits_at_chunks_max_n():
    """The wrapper takes the chunk form up to ``CHUNKS_MAX_N`` states and
    the walk form above (both one count of ``ssm_scan_bwd``)."""
    assert scan.CHUNKS_MAX_N == 64
    assert [scan.bwd_route(n) for n in (1, 16, 64, 65, scan.MAX_STATE)] == [
        "chunks", "chunks", "chunks", "walk", "walk"]


@pytest.mark.parametrize("t,kind,dt_scale", [(130, "mixed", 1.0),
                                             (130, "general", 60.0),
                                             (40, "per_head", 1.0)])
def test_exp2_fold_holds_against_the_accurate_exp(t, kind, dt_scale):
    """Every exponential as 2^(dt (A log2 e)) flushed below 2^-126, as the
    kernels take them: within 1e-4 of each gradient's largest of the
    accurate exp's emulation and of the plain backward, decays that
    underflow included."""
    x, dt, a, bm, cm, d, dy, dh = _inputs(2, t, 8, 16, kind, 5 + t,
                                          dt_scale=dt_scale)
    tx = [torch.tensor(z) for z in (x, dt, a, bm, cm, d)]
    _, _, hc = ssm_scan_with_states_ref(*tx)
    args = (*tx, hc, torch.tensor(dy), torch.tensor(dh))
    fast = emulate_chunk_form(*args, exp2=True)
    exact = emulate_chunk_form(*args, exp2=False)
    plain = ssm_scan_bwd_ref(*args)
    for name, f, e, p in zip(NAMES, fast, exact, plain):
        _close(name, f.numpy(), e.numpy())
        _close(name, f.numpy(), p.numpy())
