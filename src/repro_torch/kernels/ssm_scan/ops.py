"""Wrappers of the selective-SSM scan kernels (``csrc/ssm_scan.cu``,
forward; ``csrc/ssm_scan_bwd.cu``, backward) and the autograd Function
that joins them.

On CUDA tensors they launch the kernels, whatever the sizes; on CPU
tensors they run the plain versions of
:mod:`repro_torch.kernels.ssm_scan.ref`.  The kernels read x in its own
type where that is float32 or bfloat16 (it is not converted; bf16 to f32
is exact, so the result is the same x's in f32), and the other inputs in
float32.

:func:`ssm_scan` goes through :class:`SSMScan` where an input requires
grad under grad mode: the forward then also writes the state at the
start of every ``CHUNK`` steps, which the Function saves for the
backward kernel.  Any other call is the single forward launch without
checkpoints.  The backward uses no atomics: it writes partial sums of
dB, dC (per block of channels), dA and dD (per batch row), which are
added by ``torch.sum`` over their first axis, so two calls on the same
inputs give the same bits.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.ssm_scan.ref import (CHUNK, ssm_scan_bwd_ref,
                                              ssm_scan_with_states_ref)

NAME = "ssm_scan"
BWD_NAME = "ssm_scan_bwd"
F32 = torch.float32
X_TYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [kc.P] * 6 + [kc.I] * 5 + [kc.P] * 4
_BWD_ARGTYPES = [kc.P] * 10 + [kc.I] * 5 + [kc.P] * 7
MAX_STATE = 16 * 32


def _card_inputs(x, dt, A, Bm, Cm, D):
    """The kernels' inputs: x contiguous in its own type (float32 or
    bfloat16, else float32), the rest contiguous float32, each checked
    for its shape; returns (tensors, pointers)."""
    b, t, di = x.shape
    n = A.shape[1]
    if n > MAX_STATE:
        raise ValueError(f"ssm_scan takes at most {MAX_STATE} states, not "
                         f"{n}")
    x = (x if x.dtype in X_TYPES else x.to(F32)).contiguous()
    args = [x] + [z.to(F32).contiguous() for z in (dt, A, Bm, Cm, D)]
    shapes = ((b, t, di), (b, t, di), (di, n), (b, t, n), (b, t, n), (di,))
    names = ("x", "dt", "A", "Bm", "Cm", "D")
    types = (x.dtype,) + (F32,) * 5
    ptrs = [kc.check(z, nm, ty, sh)
            for z, nm, ty, sh in zip(args, names, types, shapes)]
    return args, ptrs


def ssm_scan_fwd(x, dt, A, Bm, Cm, D, *, with_states: bool = False):
    """x/dt [B, T, di], A [di, N], Bm/Cm [B, T, N], D [di] (any float
    type; x float32 or bfloat16 as given, the rest float32 inside) ->
    ``(y [B, T, di], h_final [B, di, N])``, both float32, from a zero
    initial state; with ``with_states`` also ``h_chunks [B, ceil(T /
    CHUNK), di, N]`` float32, the state at the start of every ``CHUNK``
    steps."""
    if not x.is_cuda:
        y, h, hc = ssm_scan_with_states_ref(x, dt, A, Bm, Cm, D,
                                            chunk=CHUNK if with_states else 0)
        return (y, h, hc) if with_states else (y, h)
    b, t, di = x.shape
    n = A.shape[1]
    (x, *_), ptrs = _card_inputs(x, dt, A, Bm, Cm, D)
    y = torch.empty((b, t, di), dtype=F32, device=x.device)
    h = torch.empty((b, di, n), dtype=F32, device=x.device)
    hc = (torch.empty((b, -(-t // CHUNK), di, n), dtype=F32, device=x.device)
          if with_states else None)
    fn = kc.kernel_fn(NAME, "ssm_scan_launch", _ARGTYPES)
    kc.launch(NAME, fn, *ptrs, b, t, di, n, int(x.dtype == torch.bfloat16),
              y.data_ptr(), h.data_ptr(),
              None if hc is None else hc.data_ptr())
    return (y, h, hc) if with_states else (y, h)


def ssm_scan_bwd(x, dt, A, Bm, Cm, D, h_chunks, dy, dh_final=None):
    """The backward: ``(dx, ddt, dA, dBm, dCm, dD)`` from the forward's
    inputs, its checkpoints ``h_chunks`` and the gradients of y (dy [B,
    T, di]) and of the final state (dh_final [B, di, N], or None for 0).
    dx comes back in x's type (float32 or bfloat16; float32 for any
    other), the rest in float32.  On the card one launch of the backward
    kernel, then ``torch.sum`` of its partial sums."""
    if not x.is_cuda:
        return ssm_scan_bwd_ref(x, dt, A, Bm, Cm, D, h_chunks, dy, dh_final)
    b, t, di = x.shape
    n = A.shape[1]
    (x, *_), ptrs = _card_inputs(x, dt, A, Bm, Cm, D)
    hc = h_chunks.to(F32).contiguous()
    dy = dy.to(F32).contiguous()
    extra = [kc.check(hc, "h_chunks", F32, (b, -(-t // CHUNK), di, n)),
             kc.check(dy, "dy", F32, (b, t, di))]
    if dh_final is None:
        extra.append(None)
    else:
        dh_final = dh_final.to(F32).contiguous()
        extra.append(kc.check(dh_final, "dh_final", F32, (b, di, n)))
    fn = kc.kernel_fn(BWD_NAME, "ssm_scan_bwd_launch", _BWD_ARGTYPES)
    channels, scratch_floats = bwd_plan(n)
    blocks = -(-di // channels)
    scratch = torch.empty((b * blocks * scratch_floats,), dtype=F32,
                          device=x.device)
    dx = torch.empty((b, t, di), dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, t, di), dtype=F32, device=x.device)
    dbp = torch.empty((blocks, b, t, n), dtype=F32, device=x.device)
    dcp = torch.empty_like(dbp)
    dap = torch.empty((b, di, n), dtype=F32, device=x.device)
    ddp = torch.empty((b, di), dtype=F32, device=x.device)
    kc.launch(BWD_NAME, fn, *ptrs, *extra, scratch.data_ptr(), b, t, di, n,
              int(x.dtype == torch.bfloat16), dx.data_ptr(), ddt.data_ptr(),
              dbp.data_ptr(), dcp.data_ptr(), dap.data_ptr(), ddp.data_ptr())
    return dx, ddt, dap.sum(0), dbp.sum(0), dcp.sum(0), ddp.sum(0)


def bwd_plan(n: int) -> tuple[int, int]:
    """(channels per block, floats of global scratch per block) of the
    backward kernel for ``n`` states, from the C source's shape: its dB
    and dC partial sums have ceil(di / channels) rows, and it keeps each
    chunk's tile-start states in the scratch."""
    plan = tuple(kc.kernel_fn(BWD_NAME, symbol, [kc.I])(n) for symbol in (
        "ssm_scan_bwd_channels", "ssm_scan_bwd_scratch"))
    if min(plan) <= 0:
        raise ValueError(f"ssm_scan_bwd takes at most {MAX_STATE} states, "
                         f"not {n}")
    return plan


class SSMScan(torch.autograd.Function):
    """The scan with its gradient from the backward kernel: the forward
    saves x (in its own type), dt, A, Bm, Cm, D and the state
    checkpoints; the backward launches :func:`ssm_scan_bwd` (its plain
    version on the CPU).  The final state's gradient may be None (0)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D):
        y, h, hc = ssm_scan_fwd(x, dt, A, Bm, Cm, D, with_states=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, hc)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bm, Cm, D, hc = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=F32, device=x.device)
        grads = ssm_scan_bwd(x, dt, A, Bm, Cm, D, hc, dy, dh)
        return tuple(gr.to(z.dtype)
                     for gr, z in zip(grads, (x, dt, A, Bm, Cm, D)))


def ssm_scan(x, dt, A, Bm, Cm, D):
    """x/dt [B, T, di], A [di, N], Bm/Cm [B, T, N], D [di] (any float
    type; x float32 or bfloat16 as given, the rest float32 inside) ->
    ``(y [B, T, di], h_final [B, di, N])``, both float32, from a zero
    initial state.  Differentiable: where an input requires grad under
    grad mode the call goes through :class:`SSMScan`."""
    if torch.is_grad_enabled() and any(
            z.requires_grad for z in (x, dt, A, Bm, Cm, D)):
        return SSMScan.apply(x, dt, A, Bm, Cm, D)
    return ssm_scan_fwd(x, dt, A, Bm, Cm, D)
