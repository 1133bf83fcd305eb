"""Port parity, the kernels of the LM serving slice: the plain PyTorch
versions of ``flash_attention`` and ``ssm_scan`` against the JAX
package's Pallas kernels in interpret mode, and the scan's final state
against ``repro.models.ssm.scan_chunked``, on the CPU.

On the CPU each port wrapper runs its plain version; the CUDA kernels run
only on a card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Tolerances: float32 attention within 2e-5 (the softmax sums run in
another order), bfloat16 inputs within 3e-2 of the float32 oracle (the
output is rounded to bfloat16, 2^-8 relative at |out| up to ~4); the scan
within 2e-5 (``exp`` and the sums over the state differ in the last bits
between PyTorch and XLA).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as jfa  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jattn_ref  # noqa: E402
from repro.kernels.ssm_scan import ops as jscan  # noqa: E402
from repro.models.ssm import scan_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
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
    """bf16 goes to the tensor-core kernel, float32 to the CUDA-core one;
    any other type raises with the wrapper's message."""
    assert fa.design(torch.bfloat16) == "wgmma"
    assert fa.design(torch.float32) == "simt"
    with pytest.raises(ValueError, match="float32 or bfloat16, not "
                                         "torch.float16"):
        fa.design(torch.float16)


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
