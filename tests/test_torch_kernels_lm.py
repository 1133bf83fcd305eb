"""Port parity, the kernels of the LM slices: the plain PyTorch versions
of ``flash_attention`` and ``ssm_scan`` against the JAX package's Pallas
kernels in interpret mode, the scan's final state against
``repro.models.ssm.scan_chunked``, and the flash backward
(``attention_bwd_ref``, the plain version of the backward kernels, and
``attention_with_lse_ref``'s lse) against ``chunked_attention``'s
``custom_vjp``, on the CPU.

On the CPU each port wrapper runs its plain version; the CUDA kernels run
only on a card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Tolerances: float32 attention within 2e-5 (the softmax sums run in
another order), bfloat16 inputs within 3e-2 of the float32 oracle (the
output is rounded to bfloat16, 2^-8 relative at |out| up to ~4); the scan
within 2e-5 (``exp`` and the sums over the state differ in the last bits
between PyTorch and XLA); the backward elementwise within
``attention_bwd_bounds`` (in bfloat16 2^-7 |y| for a flip of the
output's rounding, 2^-6 of the root of the sum of squared terms for
flips of p's and ds's roundings, which add as a random walk, and 2^-15
of a sum that bounds the cancelling dp - delta; in float32 2^-16 of that
sum: f32 sums in another order), the forward's lse within 1e-5.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jfa  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jattn_ref  # noqa: E402
from repro.kernels.ssm_scan import ops as jscan  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.ssm import scan_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_bounds, attention_bwd_ref, attention_ref,
    attention_with_lse_ref)
from repro_torch.kernels.ssm_scan import ops as scan  # noqa: E402


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, skv, d)).astype(np.float32))


# The shapes of tests/test_kernels.py's flash cases, plus q_offset > 0 and
# a head size of 16 (the reduced configs').
FLASH_CASES = [
    (1, 4, 4, 128, 128, 64, True, 0),
    (2, 8, 2, 128, 256, 64, True, 0),
    (1, 4, 1, 130, 190, 32, True, 0),     # ragged Sq and Skv
    (1, 2, 2, 128, 128, 128, False, 0),
    (2, 4, 2, 256, 128, 64, False, 0),
    (1, 4, 2, 64, 192, 16, True, 128),    # a chunk after 128 cached keys
]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,q_offset", FLASH_CASES)
def test_flash_attention_plain_matches_the_pallas_kernel(b, hq, hkv, sq, skv,
                                                         d, causal, q_offset):
    q, k, v = _qkv(b * sq * skv + d, b, hq, hkv, sq, skv, d)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, q_offset=q_offset,
                               force_kernel=True, interpret=True)
    got = fa.flash_attention(T(q), T(k), T(v), causal=causal,
                             q_offset=q_offset)
    assert got.dtype == torch.float32 and got.shape == (b, hq, sq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_flash_attention_plain_bf16():
    q, k, v = _qkv(9, 1, 2, 2, 128, 128, 64)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)  # noqa: E731
    want = jfa.flash_attention(bf(q), bf(k), bf(v), causal=True,
                               force_kernel=True, interpret=True)
    # The same bf16 values on both sides: round through bfloat16 once.
    tq, tk, tv = (T(np.asarray(bf(x), np.float32)).to(torch.bfloat16)
                  for x in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    f32 = jattn_ref(*(jnp.asarray(np.asarray(bf(x), np.float32))
                      for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(f32),
                               atol=3e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


def test_flash_attention_plain_zeroes_a_row_without_keys():
    """With q_offset -1 the first query sees no key: the Pallas kernel's
    ``l == 0`` guard gives 0 there, and so does the plain version."""
    q, k, v = _qkv(3, 1, 4, 2, 128, 128, 16)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, q_offset=-1, force_kernel=True,
                               interpret=True)
    got = attention_ref(T(q), T(k), T(v), causal=True, q_offset=-1)
    assert not got[:, :, 0].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_flash_attention_guards():
    q, k, v = (T(x) for x in _qkv(0, 1, 3, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, k, v)


def test_flash_attention_design_is_chosen_by_type_alone():
    """bf16 goes to the wgmma kernel, float32 to the 3xTF32 one on
    mma.sync; any other type raises with the wrapper's message."""
    assert fa.design(torch.bfloat16) == "wgmma"
    assert fa.design(torch.float32) == "mma_tf32x3"
    with pytest.raises(ValueError, match="float32 or bfloat16, not "
                                         "torch.float16"):
        fa.design(torch.float16)


# The flash backward's grid: both types, GQA groups 1, 2 and 4, q_offset
# 0 and 24, head sizes 16, 64, 80 and 128; Sq = 37 is not a multiple of
# the 16-row chunks, so both sides pad.
BWD_CASES = [(dtype, g, q_offset, d)
             for dtype in ("float32", "bfloat16")
             for g, q_offset, d in ((1, 0, 16), (2, 24, 64), (4, 0, 80),
                                    (1, 24, 128), (2, 0, 128), (4, 24, 16))]


def _bwd_inputs(dtype, g, q_offset, d, sq=37):
    """q, k, v, dout from numpy (seeded) as JAX arrays of ``dtype``, JAX's
    forward (out, lse [B, Hkv, g, Sq]) and its vjp's (dq, dk, dv)."""
    rng = np.random.default_rng(g * 1000 + q_offset + d)
    hkv, skv = 2, sq + q_offset
    shapes = ((1, hkv * g, sq, d), (1, hkv, skv, d), (1, hkv, skv, d),
              (1, hkv * g, sq, d))
    q, k, v, do = (jnp.asarray(rng.standard_normal(sh).astype(np.float32),
                               dtype) for sh in shapes)
    kw = dict(causal=True, q_chunk=16, kv_chunk=16, q_offset=q_offset)
    out, lse = jattn._chunked_attention_fwd(q, k, v, window=0, **kw)
    _, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention(
        a, b, c, recompute_bwd=True, **kw), q, k, v)
    return (q, k, v, do), (out, lse), vjp(do)


def _torch_of(x, dtype):
    return T(np.asarray(x, np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype,g,q_offset,d", BWD_CASES)
def test_attention_bwd_plain_matches_chunked_attention_vjp(dtype, g,
                                                           q_offset, d):
    """JAX's own O and lse go into the plain backward, so the backward
    alone is compared."""
    (q, k, v, do), (out, lse), want = _bwd_inputs(dtype, g, q_offset, d)
    args = [_torch_of(x, dtype) for x in (q, k, v, out)]
    b, hq, sq, _ = q.shape
    tlse = T(np.asarray(lse)).reshape(b, hq, sq)
    tdo = _torch_of(do, dtype)
    got = attention_bwd_ref(*args, tlse, tdo, causal=True, q_offset=q_offset)
    bounds = attention_bwd_bounds(*args, tlse, tdo, causal=True,
                                  q_offset=q_offset)
    for name, x, w, bound, like in zip(("dq", "dk", "dv"), got, want, bounds,
                                       args):
        assert x.dtype == like.dtype and x.shape == like.shape, name
        err = (x.float() - _torch_of(w, "float32")).abs()
        assert bool((err <= bound).all()), (
            f"{name}: {float(err.max())}, bound there "
            f"{float(bound.flatten()[err.argmax()])}")
        # The bound is not vacuous: under 4% (bf16) or 0.1% (f32) of the
        # largest |output|.
        scale = float(x.float().abs().max())
        assert float(bound.max()) < (0.04 if dtype == "bfloat16"
                                     else 1e-3) * scale, name


@pytest.mark.parametrize("dtype,g,q_offset,d", BWD_CASES[::3])
def test_attention_lse_matches_chunked_attention(dtype, g, q_offset, d):
    (q, k, v, _), (out, lse), _ = _bwd_inputs(dtype, g, q_offset, d)
    got, got_lse = attention_with_lse_ref(
        *(_torch_of(x, dtype) for x in (q, k, v)), causal=True,
        q_offset=q_offset)
    assert got_lse.dtype == torch.float32 and got_lse.shape == got.shape[:3]
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(lse).reshape(got_lse.shape),
                               atol=1e-5, rtol=0)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=2e-5)


def test_attention_lse_of_a_row_without_keys_is_the_minimum():
    q, k, v = (T(x) for x in _qkv(3, 1, 4, 2, 16, 16, 16))
    out, lse = attention_with_lse_ref(q, k, v, causal=True, q_offset=-1)
    assert not out[:, :, 0].any()
    assert bool((lse[:, :, 0] == torch.finfo(torch.float32).min).all())
    assert bool((lse[:, :, 1:] > -1e30).all())
    dq, dk, dv = attention_bwd_ref(q, k, v, out, lse, torch.ones_like(out),
                                   causal=True, q_offset=-1)
    assert not dq[:, :, 0].any() and bool(torch.isfinite(dk).all())


def test_flash_function_on_the_cpu_is_the_two_plain_versions():
    """Through autograd, ``flash_attention`` on CPU tensors gives the plain
    forward and ``attention_bwd_ref`` of its (out, lse) as gradients; a
    call without grad is the plain forward alone."""
    q, k, v = (T(x).requires_grad_(True)
               for x in _qkv(5, 1, 4, 2, 20, 28, 16))
    dout = T(np.random.default_rng(6).standard_normal((1, 4, 20, 16))
             .astype(np.float32))
    out = fa.flash_attention(q, k, v, causal=True, q_offset=8)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), dout)
    with torch.no_grad():
        want_out, lse = attention_with_lse_ref(q, k, v, causal=True,
                                               q_offset=8)
        want = attention_bwd_ref(q, k, v, want_out, lse, dout, causal=True,
                                 q_offset=8)
        plain = fa.flash_attention(q, k, v, causal=True, q_offset=8)
    assert plain.grad_fn is None and torch.equal(plain, want_out)
    assert torch.equal(out.detach(), want_out)
    for got, w in zip(grads, want):
        assert torch.equal(got, w)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: half away
    from zero at bit 13, on the int32 view of the bits."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul_tf32(a: torch.Tensor, b: torch.Tensor, terms: int):
    """a @ b as the card's mma.sync sums it from TF32 operands: 1xTF32
    (hi hi) or 3xTF32 (lo hi + hi lo + hi hi, hi = tf32(x), lo = tf32(x -
    hi)), the products in float64, the result in float32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    f64 = lambda x: x.double()  # noqa: E731
    out = f64(a_hi) @ f64(b_hi)
    if terms == 3:
        out = f64(a_lo) @ f64(b_hi) + f64(a_hi) @ f64(b_lo) + out
    return out.float()


def _attention_tf32(q, k, v, terms: int, *, causal: bool, q_offset: int):
    """``attention_ref`` with both products (Q K^T and P V) in 1xTF32 or
    3xTF32 (:func:`_matmul_tf32`): the arithmetic of the float32 kernel's
    design on the CPU."""
    hq, sq, d = q.shape[1:]
    group, skv = hq // k.shape[1], k.shape[2]
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    s = _matmul_tf32(q, kr.transpose(-1, -2), terms) * float(1.0 / d ** 0.5)
    row = torch.arange(sq)[:, None] + q_offset
    mask = (row >= torch.arange(skv)[None, :] if causal
            else torch.ones((sq, skv), dtype=torch.bool))
    s = torch.where(mask, s, torch.finfo(torch.float32).min)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return _matmul_tf32(p, vr, terms) / torch.where(l == 0, 1.0, l)


def _card_flash_inputs(b, hq, hkv, sq, skv, d):
    """The inputs ``tests/test_torch_cuda.py`` gives the card's kernel."""
    rng = np.random.default_rng(sq + skv + d)
    return tuple(T(rng.standard_normal(shape).astype(np.float32))
                 for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                               (b, hkv, skv, d)))


def _max_abs_score(q, k):
    """max |(q . k) scale| over every (query, key) pair and head."""
    k = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    return float((q @ k.transpose(-1, -2)).abs().max()) / q.shape[-1] ** 0.5


# The float32 shapes of the card's flash tests, and the serve-check's
# launch (zamba2's 32 heads of 80 over a 300-token prompt).
CARD_F32_SHAPES = [
    (1, 4, 4, 130, 190, 80, True, 0),
    (2, 8, 2, 200, 200, 128, True, 0),
    (1, 4, 2, 64, 192, 16, True, 128),
    (1, 2, 2, 100, 300, 64, False, 0),
    (1, 2, 1, 1, 77, 256, True, 76),
    (1, 3, 3, 65, 65, 8, True, 0),
    (1, 32, 32, 300, 300, 80, True, 0)]


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,q_offset",
                         CARD_F32_SHAPES)
def test_flash_f32_design_needs_three_tf32_products(b, hq, hkv, sq, skv, d,
                                                    causal, q_offset):
    """Why the float32 kernel sums three TF32 products: with them its
    arithmetic lies within the card test's 2e-5 of the plain version (the
    emulation lands near 1e-6), with one product (TF32 alone, 11 bits of
    each factor) it misses 2e-5 on every shape."""
    q, k, v = _card_flash_inputs(b, hq, hkv, sq, skv, d)
    want = attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    err = {terms: float((_attention_tf32(q, k, v, terms, causal=causal,
                                         q_offset=q_offset) - want)
                        .abs().max())
           for terms in (1, 3)}
    assert err[3] <= 2e-5, err
    assert err[1] > 2e-5, err


def test_flash_f32_design_on_a_peaked_softmax():
    """Scores eight times larger (q x 8): 3xTF32's error grows with |s|,
    so the card's peaked case is held to 2^-20 max|s| max|v|; the
    emulated design lies within it."""
    q, k, v = _card_flash_inputs(2, 8, 2, 200, 200, 128)
    q = q * 8
    want = attention_ref(q, k, v, causal=True)
    got = _attention_tf32(q, k, v, 3, causal=True, q_offset=0)
    bound = 2**-20 * _max_abs_score(q, k) * float(v.abs().max())
    assert float((got - want).abs().max()) <= bound


def test_tf32_rounding_is_half_away_from_zero_at_bit_13():
    """The emulation's cvt.rna: 1 + 2^-11 (a tie) rounds up to 1 + 2^-10,
    -(1 + 2^-11) down to -(1 + 2^-10), 1 + 2^-12 to 1, and a TF32 value
    stays as it is."""
    x = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 2**-10,
                      3.0], dtype=torch.float32)
    want = torch.tensor([1 + 2**-10, -(1 + 2**-10), 1.0, 1 + 2**-10, 3.0],
                        dtype=torch.float32)
    assert torch.equal(_tf32(x), want)


def test_flash_attention_tma_ready_copies_only_a_misaligned_view():
    """TMA reads from a 16-byte aligned base: an aligned contiguous tensor
    passes through as itself, a view 2 bytes into its storage is copied to
    an aligned tensor of the same values, a transposed view is made
    contiguous."""
    x = torch.arange(2 * 3 * 40 * 16, dtype=torch.float32).to(torch.bfloat16)
    aligned = x.view(2, 3, 40, 16)
    assert aligned.data_ptr() % fa.TMA_ALIGN == 0
    assert fa.tma_ready(aligned) is aligned
    flat = torch.empty(x.numel() + 1, dtype=torch.bfloat16)
    flat[1:] = x
    view = flat[1:].view(2, 3, 40, 16)
    assert view.data_ptr() % fa.TMA_ALIGN == 2
    ready = fa.tma_ready(view)
    assert ready.data_ptr() % fa.TMA_ALIGN == 0 and ready.is_contiguous()
    assert torch.equal(ready, aligned)
    t = fa.tma_ready(aligned.transpose(1, 2))
    assert t.is_contiguous() and torch.equal(t, aligned.transpose(1, 2))


def _scan_inputs(seed, b, t, din, n, dt_shift=-1.0, head=0):
    """Random scan inputs; A general, or with head > 0 one value per head
    of `head` channels broadcast over the states (Mamba-2, as the model's
    _dt_bc builds it)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, din)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, din)) + dt_shift))
    a = -np.exp(rng.standard_normal((din, n)) * 0.5)
    if head:
        a_h = -np.exp(rng.standard_normal(-(-din // head)) * 0.5)
        a = np.repeat(a_h, head)[:din, None] * np.ones((1, n))
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)
    dv = rng.standard_normal(din).astype(np.float32)
    return (x, dt.astype(np.float32), a.astype(np.float32), bm, cm, dv)


# The shapes of tests/test_kernels.py's scan cases (random, general A),
# and a Mamba-2 case (A per head of 80 channels, as zamba2's).
@pytest.mark.parametrize("b,t,din,n,head", [
    (1, 128, 128, 16, 0), (2, 130, 100, 8, 0), (1, 64, 256, 64, 0),
    (1, 64, 160, 64, 80)],
    ids=["1-128-128-16", "2-130-100-8", "1-64-256-64",
         "per_head-1-64-160-64"])
def test_ssm_scan_plain_matches_the_pallas_kernel(b, t, din, n, head):
    args = _scan_inputs(b * t * din, b, t, din, n, head=head)
    want = jscan.ssm_scan(*(jnp.asarray(x) for x in args), force_kernel=True)
    y, h = scan.ssm_scan(*(T(x) for x in args))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    assert h.shape == (b, din, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("b,t,din,n,head", [
    (2, 48, 32, 8, 0), (1, 37, 64, 16, 0), (2, 37, 160, 16, 80)],
    ids=["2-48-32-8", "1-37-64-16", "per_head-2-37-160-16"])
def test_ssm_scan_final_state_matches_scan_chunked(b, t, din, n, head):
    args = _scan_inputs(7 + t, b, t, din, n, dt_shift=0.0, head=head)
    jargs = [jnp.asarray(x) for x in args]
    want_y, want_h = scan_chunked(*jargs, jnp.zeros((b, din, n), jnp.float32),
                                  unroll=8)
    y, h = scan.ssm_scan(*(T(x) for x in args))
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=2e-5,
                               atol=2e-5)


def test_ssm_scan_takes_bf16_inputs_and_returns_f32():
    args = [T(x) for x in _scan_inputs(1, 1, 16, 32, 8)]
    args[0] = args[0].to(torch.bfloat16)
    y, h = scan.ssm_scan(*args)
    want, _ = scan.ssm_scan(args[0].float(), *args[1:])
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, want, rtol=0, atol=0)
