"""Wrappers of the selective-SSM scan kernels (``csrc/ssm_scan.cu``,
forward; ``csrc/ssm_scan_bwd.cu``, backward for a general [di, N] A;
``csrc/ssm_scan_bwd_chunked.cu``, backward for Mamba-2's per-head decay)
and the autograd Functions that join them.

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

:func:`ssm_scan_heads` takes Mamba-2's per-head dt_h [B, T, H] and a_h
[H]; it runs the same forward on their broadcast, and its Function,
:class:`SSMScanHeads`, the chunked backward, which returns the gradients
of dt_h and a_h directly (partial sums per group of heads, chunk and
batch row, added by ``torch.sum`` in the same way).  The route is the
entry that was called; neither falls back to the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.ssm_scan.ref import (CHUNK, heads_to_channels,
                                              ssm_scan_bwd_ref,
                                              ssm_scan_heads_bwd_ref,
                                              ssm_scan_with_states_ref)

NAME = "ssm_scan"
BWD_NAME = "ssm_scan_bwd"
HEADS_BWD_NAME = "ssm_scan_heads_bwd"
F32 = torch.float32
X_TYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [kc.P] * 6 + [kc.I] * 5 + [kc.P] * 4
_BWD_ARGTYPES = [kc.P] * 10 + [kc.I] * 5 + [kc.P] * 7
_HEADS_BWD_ARGTYPES = [kc.P] * 10 + [kc.I] * 6 + [kc.P] * 7
MAX_STATE = 16 * 32
MAX_GRID_YZ = 65535   # a launch's grid in y and z
# The per-head backward's shapes: heads of HEADS_P channels, N a multiple
# of 4 up to HEADS_MAX_N states.
HEADS_P, HEADS_MAX_N = 64, 64


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


def heads_bwd_group() -> int:
    """Heads per block of the per-head backward (its dB and dC partial
    sums have ceil(H / that) rows), from the C source."""
    return kc.kernel_fn(HEADS_BWD_NAME, "ssm_scan_heads_bwd_group", [])()


def ssm_scan_heads_bwd(x, dt_h, a_h, Bm, Cm, D, h_chunks, dy, dh_final=None):
    """The backward for Mamba-2's per-head decay: ``(dx, ddt_h, da_h,
    dBm, dCm, dD)`` from x [B, T, H P], dt_h [B, T, H], a_h [H], Bm/Cm
    [B, T, N], D [H P], the forward's checkpoints ``h_chunks`` [B,
    ceil(T / CHUNK), H P, N], dy [B, T, H P] and dh_final [B, H P, N] (or
    None for 0).  dx comes back in x's type (float32 or bfloat16; float32
    for any other), the rest in float32.

    On the card the chunked kernel (``csrc/ssm_scan_bwd_chunked.cu``): a
    launch for the gradient of every chunk's end state, then one block per
    (chunk, group of heads), then ``torch.sum`` of the partial sums.  It
    takes heads of ``HEADS_P`` channels and N a multiple of 4 up to
    ``HEADS_MAX_N`` states, and raises on any other shape."""
    if not x.is_cuda:
        return ssm_scan_heads_bwd_ref(x, dt_h, a_h, Bm, Cm, D, h_chunks, dy,
                                      dh_final)
    b, t, di = x.shape
    nh, n = a_h.shape[0], Bm.shape[-1]
    p = di // nh if nh else 0
    if (nh == 0 or di != nh * p or p != HEADS_P or n % 4
            or not 0 < n <= HEADS_MAX_N):
        raise ValueError(
            f"ssm_scan_heads_bwd takes heads of {HEADS_P} channels and a "
            f"multiple of 4 states up to {HEADS_MAX_N}, not {di} channels "
            f"in {nh} heads with {n} states; the general route is ssm_scan")
    group = heads_bwd_group()
    groups, nc = -(-nh // group), -(-t // CHUNK)
    if b > MAX_GRID_YZ or groups > MAX_GRID_YZ:
        raise ValueError(f"ssm_scan_heads_bwd takes at most {MAX_GRID_YZ} "
                         f"batch rows and groups of {group} heads, not {b} "
                         f"and {groups}")
    x = (x if x.dtype in X_TYPES else x.to(F32)).contiguous()
    args = [x] + [z.to(F32).contiguous()
                  for z in (dt_h, a_h, Bm, Cm, D, h_chunks, dy)]
    shapes = ((b, t, di), (b, t, nh), (nh,), (b, t, n), (b, t, n), (di,),
              (b, nc, di, n), (b, t, di))
    names = ("x", "dt_h", "a_h", "Bm", "Cm", "D", "h_chunks", "dy")
    # The tiles go through 16-byte cp.async copies.
    args = [z if z.data_ptr() % 16 == 0 else z.clone() for z in args]
    ptrs = [kc.check(z, nm, z.dtype if i == 0 else F32, sh)
            for i, (z, nm, sh) in enumerate(zip(args, names, shapes))]
    if dh_final is None:
        ptrs.append(None)
    else:
        dh = dh_final.to(F32).contiguous()
        dh = dh if dh.data_ptr() % 16 == 0 else dh.clone()
        ptrs.append(kc.check(dh, "dh_final", F32, (b, di, n)))
    dev = x.device
    g_chunks = torch.empty((b, nc, di, n), dtype=F32, device=dev)
    dx = torch.empty((b, t, di), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, t, nh), dtype=F32, device=dev)
    dbp = torch.empty((groups, b, t, n), dtype=F32, device=dev)
    dcp = torch.empty_like(dbp)
    dap = torch.empty((b, nc, nh), dtype=F32, device=dev)
    ddp = torch.empty((b, nc, di), dtype=F32, device=dev)
    fn = kc.kernel_fn(HEADS_BWD_NAME, "ssm_scan_heads_bwd_launch",
                      _HEADS_BWD_ARGTYPES)
    kc.launch(HEADS_BWD_NAME, fn, *ptrs, g_chunks.data_ptr(), b, t, nh, p, n,
              int(x.dtype == torch.bfloat16), dx.data_ptr(), ddt.data_ptr(),
              dbp.data_ptr(), dcp.data_ptr(), dap.data_ptr(), ddp.data_ptr())
    return (dx, ddt, dap.sum((0, 1)), dbp.sum(0), dcp.sum(0),
            ddp.sum((0, 1)))


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


class SSMScanHeads(torch.autograd.Function):
    """The scan for Mamba-2's per-head decay with its gradient from the
    chunked backward kernel: the forward broadcasts dt_h and a_h over
    each head's channels (outside autograd) and runs :func:`ssm_scan_fwd`
    with checkpoints; it saves x (in its own type), dt_h, a_h, Bm, Cm, D
    and the checkpoints; the backward launches :func:`ssm_scan_heads_bwd`
    (its plain version on the CPU) and returns the gradients of dt_h and
    a_h directly.  The final state's gradient may be None (0)."""

    @staticmethod
    def forward(ctx, x, dt_h, a_h, Bm, Cm, D):
        dt, A = heads_to_channels(dt_h, a_h, x.shape[-1] // a_h.shape[0],
                                  Bm.shape[-1])
        y, h, hc = ssm_scan_fwd(x, dt, A, Bm, Cm, D, with_states=True)
        ctx.save_for_backward(x, dt_h, a_h, Bm, Cm, D, hc)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt_h, a_h, Bm, Cm, D, hc = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=F32, device=x.device)
        grads = ssm_scan_heads_bwd(x, dt_h, a_h, Bm, Cm, D, hc, dy, dh)
        return tuple(gr.to(z.dtype)
                     for gr, z in zip(grads, (x, dt_h, a_h, Bm, Cm, D)))


def ssm_scan_heads(x, dt_h, a_h, Bm, Cm, D):
    """Mamba-2's scan: x [B, T, H P], dt_h [B, T, H], a_h [H] (negative),
    Bm/Cm [B, T, N], D [H P] -> ``(y [B, T, H P], h_final [B, H P, N])``,
    both float32, from a zero initial state: :func:`ssm_scan` with dt and
    A broadcast over each head's P channels.  Differentiable: where an
    input requires grad under grad mode the call goes through
    :class:`SSMScanHeads`, else it is the single forward launch."""
    if torch.is_grad_enabled() and any(
            z.requires_grad for z in (x, dt_h, a_h, Bm, Cm, D)):
        return SSMScanHeads.apply(x, dt_h, a_h, Bm, Cm, D)
    dt, A = heads_to_channels(dt_h, a_h, x.shape[-1] // a_h.shape[0],
                              Bm.shape[-1])
    return ssm_scan_fwd(x, dt, A, Bm, Cm, D)
