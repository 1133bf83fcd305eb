"""Wrapper of the chunk-parallel SSD scan kernel (``csrc/ssd_chunked.cu``),
forward only.

On CUDA tensors :func:`ssd_chunked` launches the kernel (one count of
``ssd_chunked`` a call: the launcher starts three kernels, the chunks'
end states, their start states in chunk order, then the outputs); on
CPU tensors it runs :func:`repro_torch.kernels.ssd.ref.ssd_chunked_ref`.
Where an input requires grad under grad mode it raises on either device:
training through the SSD path is not ported (no backward kernel yet), and
nothing switches to another route.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common as kc
from repro_torch.kernels.ssd.ref import ssd_chunked_ref

NAME = "ssd_chunked"
F32 = torch.float32
_ARGTYPES = [kc.P] * 9 + [kc.I] * 7 + [kc.P] * 3
# The kernel's shapes: heads of HEAD_P channels, at most MAX_N states and
# MAX_CHUNK steps a chunk.
HEAD_P, MAX_N, MAX_CHUNK = 64, 64, 256
MAX_GRID_YZ = 65535
NO_GRAD = ("training through ssm_impl='ssd' is not ported: the SSD "
           "kernel has no backward yet (ROADMAP.md section 1, item 9); "
           "train with ssm_impl='scan'")


def ssd_chunked(x, dt_h, a_h, bm, cm, dvec, h0=None, *, chunk: int = 128):
    """Mamba-2's chunk-parallel scan: x [B, T, H P], dt_h [B, T, H], a_h
    [H] (negative), bm/cm [B, T, N], dvec [H P], h0 [B, H P, N] (None:
    zeros) -> ``(y [B, T, H P], h_final [B, H P, N] float32)``; y in
    bfloat16 for a bfloat16 x, else float32 (the reference's op_dt).
    The kernel takes heads of ``HEAD_P`` channels, N up to ``MAX_N`` and
    chunks up to ``MAX_CHUNK`` steps, and raises on any other shape."""
    if torch.is_grad_enabled() and any(
            z is not None and z.requires_grad
            for z in (x, dt_h, a_h, bm, cm, dvec, h0)):
        raise NotImplementedError(NO_GRAD)
    if x.shape[1] == 0:
        raise ValueError("ssd_chunked takes at least one step")
    if not x.is_cuda:
        return ssd_chunked_ref(x, dt_h, a_h, bm, cm, dvec, h0, chunk=chunk)
    b, t, di = x.shape
    nh, n = a_h.shape[0], bm.shape[-1]
    p = di // nh if nh else 0
    if (nh == 0 or di != nh * p or p != HEAD_P or not 0 < n <= MAX_N
            or not 0 < chunk <= MAX_CHUNK):
        raise ValueError(
            f"ssd_chunked takes heads of {HEAD_P} channels, at most {MAX_N} "
            f"states and chunks of 1 to {MAX_CHUNK} steps, not {di} channels "
            f"in {nh} heads with {n} states and chunk {chunk}")
    if b > MAX_GRID_YZ or nh > MAX_GRID_YZ:
        raise ValueError(f"ssd_chunked takes at most {MAX_GRID_YZ} batch "
                         f"rows and heads, not {b} and {nh}")
    x_bf16 = x.dtype == torch.bfloat16
    x = (x if x_bf16 else x.to(F32)).contiguous()
    args = [z.to(F32).contiguous() for z in (dt_h, a_h, bm, cm, dvec)]
    shapes = ((b, t, nh), (nh,), (b, t, n), (b, t, n), (di,))
    names = ("dt_h", "a_h", "bm", "cm", "dvec")
    ptrs = [kc.check(x, "x", x.dtype, (b, t, di))] + [
        kc.check(z, nm, F32, sh) for z, nm, sh in zip(args, names, shapes)]
    if h0 is None:
        ptrs.append(None)
    else:
        h0 = h0.to(F32).contiguous()
        ptrs.append(kc.check(h0, "h0", F32, (b, di, n)))
    dev = x.device
    l = min(chunk, t)
    nc = -(-t // l)
    dstate = torch.empty((b, nc, nh, p, n), dtype=F32, device=dev)
    cum_last = torch.empty((b, nc, nh), dtype=F32, device=dev)
    y = torch.empty_like(x)
    h_final = torch.empty((b, di, n), dtype=F32, device=dev)
    fn = kc.kernel_fn(NAME, "ssd_chunked_launch", _ARGTYPES)
    kc.launch(NAME, fn, *ptrs, dstate.data_ptr(), cum_last.data_ptr(), b, t,
              nh, p, n, l, int(x_bf16), y.data_ptr(), h_final.data_ptr())
    return y, h_final
