"""Wrappers of the selective-SSM scan kernels (``csrc/ssm_scan.cu``,
forward; ``csrc/ssm_scan_bwd.cu``, backward for a general [di, N] A, in
two forms routed by N; ``csrc/ssm_scan_bwd_chunked.cu``, backward for
Mamba-2's per-head decay) and the autograd Functions that join them.

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
inputs give the same bits.  :func:`ssm_scan_bwd` takes the chunk form
(:func:`ssm_scan_bwd_chunks`, chunk-parallel over the checkpoints) up to
``CHUNKS_MAX_N`` states and the walk form (:func:`ssm_scan_bwd_walk`,
a block walks all T steps) above: :func:`bwd_route` names the form, and
each is one count of ``ssm_scan_bwd``.

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
_CHUNKS_BWD_ARGTYPES = [kc.P] * 11 + [kc.I] * 5 + [kc.P] * 7
_HEADS_BWD_ARGTYPES = [kc.P] * 10 + [kc.I] * 6 + [kc.P] * 7
MAX_STATE = 16 * 32
MAX_GRID_YZ = 65535   # a launch's grid in y and z
# The general-A backward's chunk form takes up to CHUNKS_MAX_N states, its
# walk form more.
CHUNKS_MAX_N = 64
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
    other), the rest in float32.  On the card the form that
    :func:`bwd_route` names for N: :func:`ssm_scan_bwd_chunks` or
    :func:`ssm_scan_bwd_walk`."""
    if not x.is_cuda:
        return ssm_scan_bwd_ref(x, dt, A, Bm, Cm, D, h_chunks, dy, dh_final)
    form = (ssm_scan_bwd_chunks if bwd_route(A.shape[1]) == "chunks"
            else ssm_scan_bwd_walk)
    return form(x, dt, A, Bm, Cm, D, h_chunks, dy, dh_final)


def bwd_route(n: int) -> str:
    """The form of the general-A backward for ``n`` states: "chunks" up
    to ``CHUNKS_MAX_N``, else "walk"."""
    return "chunks" if n <= CHUNKS_MAX_N else "walk"


def _bwd_card_args(x, dt, A, Bm, Cm, D, h_chunks, dy, dh_final):
    """The backward kernels' inputs, checked: ``(x, pointers, tensors)``,
    the pointers of x .. D, h_chunks, dy and dh_final (None for 0), and
    the tensors behind them, which the caller holds until its launch."""
    b, t, di = x.shape
    n = A.shape[1]
    args, ptrs = _card_inputs(x, dt, A, Bm, Cm, D)
    hc = h_chunks.to(F32).contiguous()
    dy = dy.to(F32).contiguous()
    ptrs += [kc.check(hc, "h_chunks", F32, (b, -(-t // CHUNK), di, n)),
             kc.check(dy, "dy", F32, (b, t, di))]
    if dh_final is None:
        ptrs.append(None)
    else:
        dh_final = dh_final.to(F32).contiguous()
        ptrs.append(kc.check(dh_final, "dh_final", F32, (b, di, n)))
    return args[0], ptrs, (args, hc, dy, dh_final)


def ssm_scan_bwd_chunks(x, dt, A, Bm, Cm, D, h_chunks, dy, dh_final=None):
    """:func:`ssm_scan_bwd`'s chunk form, N up to ``CHUNKS_MAX_N``: one
    launch of ``ssm_scan_bwd_chunks_launch`` (a carry kernel over chunks
    1 .. of the summaries that pass g back across a chunk, then a block
    per group of channels, chunk and batch row), then ``torch.sum`` of
    its partial sums.  Raises on more states, or more than
    ``MAX_GRID_YZ`` batch rows or chunks."""
    b, t, di = x.shape
    n = A.shape[1]
    nc = -(-t // CHUNK)
    if b > MAX_GRID_YZ or nc > MAX_GRID_YZ:
        raise ValueError(f"ssm_scan_bwd_chunks takes at most {MAX_GRID_YZ} "
                         f"batch rows and chunks, not {b} and {nc}")
    channels, _ = bwd_plan(n, "chunks")
    x, ptrs, _keep = _bwd_card_args(x, dt, A, Bm, Cm, D, h_chunks, dy,
                                    dh_final)
    blocks = -(-di // channels)
    dev = x.device
    g_sum = torch.empty((b, nc, di, n), dtype=F32, device=dev)
    dt_sum = torch.empty((b, nc, di), dtype=F32, device=dev)
    dx = torch.empty((b, t, di), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, t, di), dtype=F32, device=dev)
    dbp = torch.empty((blocks, b, t, n), dtype=F32, device=dev)
    dcp = torch.empty_like(dbp)
    dap = torch.empty((b, nc, di, n), dtype=F32, device=dev)
    ddp = torch.empty((b, nc, di), dtype=F32, device=dev)
    fn = kc.kernel_fn(BWD_NAME, "ssm_scan_bwd_chunks_launch",
                      _CHUNKS_BWD_ARGTYPES)
    kc.launch(BWD_NAME, fn, *ptrs, g_sum.data_ptr(), dt_sum.data_ptr(), b, t,
              di, n, int(x.dtype == torch.bfloat16), dx.data_ptr(),
              ddt.data_ptr(), dbp.data_ptr(), dcp.data_ptr(), dap.data_ptr(),
              ddp.data_ptr())
    return dx, ddt, dap.sum((0, 1)), dbp.sum(0), dcp.sum(0), ddp.sum((0, 1))


def ssm_scan_bwd_walk(x, dt, A, Bm, Cm, D, h_chunks, dy, dh_final=None):
    """:func:`ssm_scan_bwd`'s walk form (a block per group of channels and
    batch row walks all T steps back), which the tree's build takes for
    N above ``CHUNKS_MAX_N``: one launch of ``ssm_scan_bwd_launch``, then
    ``torch.sum`` of its partial sums."""
    b, t, di = x.shape
    n = A.shape[1]
    channels, scratch_floats = bwd_plan(n, "walk")
    x, ptrs, _keep = _bwd_card_args(x, dt, A, Bm, Cm, D, h_chunks, dy,
                                    dh_final)
    fn = kc.kernel_fn(BWD_NAME, "ssm_scan_bwd_launch", _BWD_ARGTYPES)
    blocks = -(-di // channels)
    scratch = torch.empty((b * blocks * scratch_floats,), dtype=F32,
                          device=x.device)
    dx = torch.empty((b, t, di), dtype=x.dtype, device=x.device)
    ddt = torch.empty((b, t, di), dtype=F32, device=x.device)
    dbp = torch.empty((blocks, b, t, n), dtype=F32, device=x.device)
    dcp = torch.empty_like(dbp)
    dap = torch.empty((b, di, n), dtype=F32, device=x.device)
    ddp = torch.empty((b, di), dtype=F32, device=x.device)
    kc.launch(BWD_NAME, fn, *ptrs, scratch.data_ptr(), b, t, di, n,
              int(x.dtype == torch.bfloat16), dx.data_ptr(), ddt.data_ptr(),
              dbp.data_ptr(), dcp.data_ptr(), dap.data_ptr(), ddp.data_ptr())
    return dx, ddt, dap.sum(0), dbp.sum(0), dcp.sum(0), ddp.sum(0)


def bwd_plan(n: int, form: str) -> tuple[int, int]:
    """(channels per block, floats of global scratch per block) of the
    general-A backward's ``form`` ("chunks" or "walk") for ``n`` states,
    from the C source's shapes: its dB and dC partial sums have
    ceil(di / channels) rows.  The walk form keeps each chunk's
    tile-start states in that scratch; the chunk form's scratch is per
    call, the chunk summaries [B, chunks, di, N] and [B, chunks, di]
    (0 here)."""
    if form == "chunks":
        plan = (kc.kernel_fn(BWD_NAME, "ssm_scan_bwd_chunks_channels",
                             [kc.I])(n), 0)
    else:
        plan = tuple(kc.kernel_fn(BWD_NAME, symbol, [kc.I])(n)
                     for symbol in ("ssm_scan_bwd_channels",
                                    "ssm_scan_bwd_scratch"))
    if plan[0] <= 0 or plan[1] < 0:
        raise ValueError(f"the {form} form of ssm_scan_bwd does not take "
                         f"{n} states in this build (chunks: N <= "
                         f"{CHUNKS_MAX_N}; walk: {CHUNKS_MAX_N} < N <= "
                         f"{MAX_STATE})")
    return plan


def bwd_resident_warps(n: int, x_bf16: bool) -> dict[str, int]:
    """Resident warps an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    times the block's warps) of each kernel that the backward's form for
    ``n`` states and x's type launches, by kernel name."""
    fn = kc.kernel_fn(BWD_NAME, "ssm_scan_bwd_resident_warps", [kc.I] * 3)
    names = ({"ssm_scan_bwd_chunk_kernel": 0, "ssm_scan_bwd_carry_kernel": 1}
             if bwd_route(n) == "chunks" else {"ssm_scan_bwd_kernel": 2})
    return {name: fn(n, int(x_bf16), k) for name, k in names.items()}


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
