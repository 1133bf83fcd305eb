"""Port parity, the selective scan's backward: the plain versions of
``kernels/ssm_scan`` (``ssm_scan_with_states_ref``, ``ssm_scan_bwd_ref``)
and the ``SSMScan`` autograd Function on the CPU, against ``jax.vjp`` of
the JAX package's ``repro.models.ssm.scan_chunked`` (XLA's autodiff of
its ``lax.scan``, which is what the reference trains through) and
against autograd through the port's own plain scan.

Inputs come from numpy with a seed.  Tolerances, each with its reason:
* every gradient within 1e-5 of its largest |.| (float32 sums in
  another order than XLA's: the channel and state sums of dB, dC, du and
  q . A, the time sums of dA and dD, and the recomputed states);
* a bf16 x: the port computes dx in float32 and rounds it to bf16 once,
  so it is held to JAX's float32 gradient at the same x (its bf16 values
  in float32) within one bf16 rounding, 2^-8 |dx|, besides the 1e-5.
  JAX's own bf16 cotangent is not the yardstick: ``scan_chunked`` casts
  x to float32 twice, and the transpose of each cast rounds its term to
  bf16 before the two are added in bf16;
* the checkpoints against the forward's own states: bitwise (the same
  float32 operations in the same order);
* ``SSMScan`` against autograd through ``ssm_scan_ref``: 1e-5 of the
  largest |.| (the same math summed in another order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as scan  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import (  # noqa: E402
    CHUNK, ssm_scan_bwd_ref, ssm_scan_ref, ssm_scan_with_states_ref)

NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")


def _inputs(b, t, di, n, kind, seed, head=80):
    """numpy (x, dt, A, B, C, D, dy, dh) float32: dt from softplus, A
    "per_head" (Mamba-2: one value per head of ``head`` channels, as the
    model builds it), "general" (one per element) or "mixed" (per head
    at even channels, general at odd ones)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, di))
    dt = np.log1p(np.exp(rng.standard_normal((b, t, di)) - 1.0))
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


def _jax_grads(x, dt, a, bm, cm, d, dy, dh, unroll):
    """``jax.vjp`` of ``scan_chunked`` (h0 = 0, ``unroll`` steps a
    ``lax.scan`` tick) with cotangents dy and dh (0 where None): (y,
    h_final, gradients).  ``unroll`` groups the same steps (1 compiles in
    a quarter of the time of the model's 8)."""
    b, _, di = x.shape
    h0 = jnp.zeros((b, di, a.shape[1]), jnp.float32)
    primals = tuple(jnp.asarray(z) for z in (x, dt, a, bm, cm, d))
    (y, h), vjp = jax.vjp(
        lambda *p: jssm.scan_chunked(*p, h0, unroll=unroll), *primals)
    ct_h = jnp.zeros_like(h) if dh is None else jnp.asarray(dh)
    return y, h, vjp((jnp.asarray(dy), ct_h))


def _close(name, got, want, x_bf16=False):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    atol = 1e-5 * float(np.abs(want).max())
    rtol = 2**-8 if (x_bf16 and name == "dx") else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=name)


CASES = [
    # (b, t, di, n, A, dh given, x bf16, unroll)
    (2, 37, 160, 16, "per_head", True, False, 8),   # a head of 80 channels
    (2, 37, 48, 8, "general", True, False, 1),
    (1, 130, 70, 16, "mixed", False, False, 1),     # T past two chunks, di 70
    (2, 130, 33, 5, "general", True, False, 1),     # N not a multiple of 4
    (1, 64, 96, 16, "per_head", False, False, 1),   # T one whole chunk
    (2, 37, 100, 16, "per_head", True, True, 1),    # x in bf16
]


@pytest.mark.parametrize("b,t,di,n,kind,with_dh,bf16,unroll", CASES)
def test_bwd_ref_matches_jax_vjp_of_scan_chunked(b, t, di, n, kind, with_dh,
                                                 bf16, unroll):
    x, dt, a, bm, cm, d, dy, dh = _inputs(b, t, di, n, kind, t + di + n)
    dh = dh if with_dh else None
    x_t = torch.tensor(x).to(torch.bfloat16) if bf16 else torch.tensor(x)
    y, h, want = _jax_grads(x_t.float().numpy(), dt, a, bm, cm, d, dy, dh,
                            unroll)
    rest = [torch.tensor(z) for z in (dt, a, bm, cm, d)]
    ty, th, hc = ssm_scan_with_states_ref(x_t, *rest)
    _close("y", ty, y)
    _close("h", th, h)
    got = ssm_scan_bwd_ref(x_t, *rest, hc, torch.tensor(dy),
                           None if dh is None else torch.tensor(dh))
    assert got[0].dtype == x_t.dtype
    assert all(g.dtype == torch.float32 for g in got[1:])
    for name, g, w in zip(NAMES, got, want):
        _close(name, g, w, x_bf16=bf16)


@pytest.mark.parametrize("b,t,di,n,kind", [
    (2, 37, 20, 8, "general"), (1, 130, 24, 4, "mixed"),
    (2, 64, 160, 4, "per_head")])
def test_bwd_ref_matches_autograd_through_the_plain_scan(b, t, di, n, kind):
    x, dt, a, bm, cm, d, dy, dh = (torch.tensor(z) for z in _inputs(
        b, t, di, n, kind, 7 + t))
    leaves = [z.clone().requires_grad_(True) for z in (x, dt, a, bm, cm, d)]
    y, h = ssm_scan_ref(*leaves)
    want = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), leaves)
    _, _, hc = ssm_scan_with_states_ref(x, dt, a, bm, cm, d)
    got = ssm_scan_bwd_ref(x, dt, a, bm, cm, d, hc, dy, dh)
    for name, g, w in zip(NAMES, got, want):
        _close(name, g, w)


@pytest.mark.parametrize("t", [1, 63, 64, 65, 130])
def test_checkpoints_are_the_forward_states_at_chunk_starts(t):
    """``h_chunks[:, c]`` is the state before step c * CHUNK (the first
    is 0), bitwise the state the forward carries there; y and the final
    state are the plain scan's."""
    x, dt, a, bm, cm, d = (torch.tensor(z) for z in _inputs(
        2, t, 12, 8, "general", t)[:6])
    y, h, hc = ssm_scan_with_states_ref(x, dt, a, bm, cm, d)
    assert hc.shape == (2, -(-t // CHUNK), 12, 8)
    assert not hc[:, 0].any()
    for c in range(1, hc.shape[1]):
        _, h_c = ssm_scan_ref(x[:, :c * CHUNK], dt[:, :c * CHUNK], a,
                              bm[:, :c * CHUNK], cm[:, :c * CHUNK], d)
        assert torch.equal(hc[:, c], h_c)
    want_y, want_h = ssm_scan_ref(x, dt, a, bm, cm, d)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)


@pytest.mark.parametrize("use_h", [False, True])
def test_scan_function_matches_autograd_on_the_cpu(use_h):
    """``ssm_scan`` with inputs that require grad goes through ``SSMScan``
    (the plain forward with checkpoints, then ``ssm_scan_bwd_ref``); its
    outputs are the plain scan's bitwise, its gradients autograd's
    through ``ssm_scan_ref`` within 1e-5 of the largest |.|, with the
    final state's gradient unused (None) or given."""
    arrs = _inputs(2, 70, 40, 8, "mixed", 3, head=4)
    dy, dh = torch.tensor(arrs[6]), torch.tensor(arrs[7])
    grads = {}
    for label, fn in (("fn", scan.ssm_scan), ("ref", ssm_scan_ref)):
        leaves = [torch.tensor(z).requires_grad_(True) for z in arrs[:6]]
        y, h = fn(*leaves)
        loss = (y * dy).sum() + ((h * dh).sum() if use_h else 0.0)
        grads[label] = (y.detach(), h.detach(),
                        torch.autograd.grad(loss, leaves))
    assert isinstance(scan.ssm_scan(*(torch.tensor(z).requires_grad_(True)
                                      for z in arrs[:6]))[0].grad_fn,
                      torch.autograd.graph.Node)
    (y, h, got), (wy, wh, want) = grads["fn"], grads["ref"]
    assert torch.equal(y, wy) and torch.equal(h, wh)
    for name, g, w in zip(NAMES, got, want):
        _close(name, g, w)
    with torch.no_grad():
        out = scan.ssm_scan(*(torch.tensor(z) for z in arrs[:6]))
    assert torch.equal(out[0], wy) and out[0].grad_fn is None
