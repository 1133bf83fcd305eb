"""Port parity, zamba2's long-context serving path: the chunk-parallel SSD
scan (``ssm_impl="ssd"``), sliding-window attention in the flash forward
and windowed decode on a KV ring, against the JAX package on the CPU.

* ``ssd_chunked_ref`` (the plain version of ``csrc/ssd_chunked.cu``)
  against ``repro.models.ssm.ssd_chunked``: float32 within 1e-5 of max
  |y| (sums and cumulative sums in another order), bfloat16 within 2^-7
  of max |y| (the same roundings to bfloat16 of the same exact products:
  a flip of one is an ulp of the output), the final state within the same
  of max |h|; and the "ssd" route against the port's "scan" route.
* The windowed ``attention_ref`` against ``chunked_attention(window=)``
  (float32 within 2e-5; bfloat16 within 2^-8 |want| + 2^-8 max |v|: the
  reference rounds p to bfloat16 before PV, the plain version does not),
  ``decode_attention(window=)`` against JAX's within 1e-6.
* Reduced zamba2 (window 64, ``ssm_impl="ssd"`` with chunks of 32 so a
  100-token prompt spans ragged chunks): the windowed prefill, decode on
  a 64-slot ring and windowed decode over a padded cache, float32 logits
  within 1e-4 of the largest |logit| of JAX's decode, and within 5e-4
  absolute of JAX's windowed forward (the JAX package's own
  prefill/decode consistency bound: its decode steps the recurrence where
  its forward runs ``ssd_chunked``).

The weights come from the port's init, through a JAX tree and back
by ``convert.lm_params_from_jax``;
inputs from a numpy seed.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunked_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as scan  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import spec as sp  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

WINDOW = 64        # the reduced config's window
CHUNK = 32         # the reduced "ssd" path's chunk
ARCH = "zamba2-2.7b"


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _ssd_inputs(b, t, nh, p, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dt = np.log1p(np.exp(f(b, t, nh) - 1.0))
    a = -np.exp(0.5 * f(nh))
    return f(b, t, nh * p), dt, a, f(b, t, n), f(b, t, n), f(nh * p), \
        f(b, nh * p, n)


# ---------------------------------------------------------------------------
# The SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,nh,p,n,chunk,with_h0", [
    (2, 130, 2, 8, 4, 32, True),     # ragged: 4 chunks of 32 and one of 2
    (1, 20, 3, 8, 8, 32, False)])    # t < chunk: one chunk of 20
def test_ssd_plain_matches_jax(dtype, b, t, nh, p, n, chunk, with_h0):
    x, dt, a, bm, cm, d, h0 = _ssd_inputs(b, t, nh, p, n, seed=t + n)
    if not with_h0:
        h0 = np.zeros_like(h0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jy, jh = jssm.ssd_chunked(jnp.asarray(x).astype(jdt), *map(jnp.asarray, (
        dt, a, bm, cm, d, h0)), chunk=chunk)
    y, h = ssd_chunked_ref(T(x).to(tdt), T(dt), T(a), T(bm), T(cm), T(d),
                           T(h0) if with_h0 else None, chunk=chunk)
    assert y.dtype == tdt and h.dtype == torch.float32
    jy = np.asarray(jy.astype(jnp.float32))
    frac = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    assert np.abs(y.float().numpy() - jy).max() <= frac * np.abs(jy).max()
    jh = np.asarray(jh)
    assert np.abs(h.numpy() - jh).max() <= frac * np.abs(jh).max()


def test_ssd_route_matches_the_scan_route():
    """In float32 the chunk-parallel form and the scan are the same
    recurrence: ``ssd_chunked`` against ``ssm_scan_heads`` (both plain on
    the CPU) within 1e-5 of max |y| and max |h|."""
    x, dt, a, bm, cm, d, _ = _ssd_inputs(2, 130, 2, 8, 4, seed=5)
    y, h = ssd.ssd_chunked(T(x), T(dt), T(a), T(bm), T(cm), T(d), chunk=32)
    ys, hs = scan.ssm_scan_heads(T(x), T(dt), T(a), T(bm), T(cm), T(d))
    assert float((y - ys).abs().max()) <= 1e-5 * float(ys.abs().max())
    assert float((h - hs).abs().max()) <= 1e-5 * float(hs.abs().max())


def test_ssd_and_windowed_prefill_refuse_a_gradient():
    """Training through "ssd" or a window is the next slice: under a
    gradient both raise, naming the roadmap, on the CPU as on the card
    (no switch to the "scan" route or to a window-free call)."""
    x, dt, a, bm, cm, d, _ = _ssd_inputs(1, 8, 1, 8, 4, seed=6)
    xt = T(x).requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ssd.ssd_chunked(xt, T(dt), T(a), T(bm), T(cm), T(d), chunk=4)
    with torch.no_grad():
        ssd.ssd_chunked(xt, T(dt), T(a), T(bm), T(cm), T(d), chunk=4)
    q = torch.zeros((1, 2, 4, 16), requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        attn.prefill_attention(q, q, q, window=2)
    cfg = dataclasses.replace(C.get(ARCH).reduced(), ssm_impl="ssd")
    p = sp.init_tree(torch.Generator().manual_seed(0), ssm.ssm_spec(cfg),
                     torch.float32, "cpu")
    p["w_in_x"].requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ssm.ssm_apply(cfg, p, torch.zeros((1, 4, cfg.d_model)))


# ---------------------------------------------------------------------------
# Sliding-window attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,q_offset,skv", [
    (True, 13, 50),
    (False, 13, 40)])   # no mask: the last rows see no key in their window
def test_windowed_attention_matches_jax(dtype, causal, q_offset, skv):
    rng = np.random.default_rng(skv + q_offset)
    b, hq, hkv, sq, d, window = 1, 4, 2, 37, 16, 9
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
            for _ in range(2))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jattn.chunked_attention(
        *(jnp.asarray(z).astype(jdt) for z in (q, k, v)), causal=causal,
        window=window, q_chunk=16, kv_chunk=8, q_offset=q_offset)
    want = np.asarray(want.astype(jnp.float32))
    args = tuple(T(z).to(tdt) for z in (q, k, v))
    got = fa.flash_attention(*args, causal=causal, q_offset=q_offset,
                             window=window).float().numpy()
    assert np.array_equal(got, attention_ref(
        *args, causal=causal, q_offset=q_offset,
        window=window).float().numpy())
    tol = (2.0 ** -8 * np.abs(want) + 2.0 ** -8 * np.abs(v).max()
           if dtype == "bfloat16" else 2e-5)
    assert np.all(np.abs(got - want) <= tol)
    if not causal:
        empty = q_offset + np.arange(sq) - window + 1 >= skv
        assert empty.any() and not got[:, :, empty].any()


@pytest.mark.parametrize("cache_len,window", [(30, 8), (40, 40), (12, 64)])
def test_windowed_decode_attention_matches_jax(cache_len, window):
    rng = np.random.default_rng(cache_len)
    b, hq, hkv, s_max, d = 2, 4, 2, 40, 16
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, s_max, d)).astype(np.float32)
            for _ in range(2))
    want = jattn.decode_attention(
        jnp.asarray(q), jattn.KVCache(k=jnp.asarray(k), v=jnp.asarray(v)),
        jnp.asarray(cache_len, jnp.int32), window=window)
    got = attn.decode_attention(T(q), attn.KVCache(k=T(k), v=T(v)),
                                cache_len, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------------------
# Reduced zamba2 on the long-context path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba():
    """(jax cfg, port cfg, jax params, port params): reduced zamba2 with
    ``ssm_impl="ssd"`` and chunks of 32, float32, window 64."""
    jcfg = dataclasses.replace(JC.get(ARCH).reduced(), ssm_impl="ssd",
                               ssd_chunk=CHUNK)
    cfg = dataclasses.replace(C.get(ARCH).reduced(), ssm_impl="ssd",
                              ssd_chunk=CHUNK)
    assert cfg.window == jcfg.window == WINDOW
    jparams = _to_jax(lm.init(torch.Generator().manual_seed(0), cfg,
                              device="cpu"))
    return jcfg, cfg, jparams, convert.lm_params_from_jax(jparams,
                                                          device="cpu")


def _to_jax(tree):
    """The port's parameter tree as the reference's (the same nested
    dicts; the draw is the port's sliced init, faster than JAX's on the
    CPU), from which ``convert.lm_params_from_jax`` carries it back."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def run(zamba):
    """The tokens (2 x 104), JAX's windowed full forward over them (logits
    at every position: each depends on the tokens up to it only), and
    JAX's windowed prefill of the first 100."""
    jcfg, cfg, jparams, _ = zamba
    rng = np.random.default_rng(0)
    tk = rng.integers(0, cfg.vocab_size, (2, 104)).astype(np.int32)
    forward = np.asarray(jtfm.forward(jcfg, jparams, jnp.asarray(tk), None,
                                      window=WINDOW).logits)
    last, cache = jlm.prefill(jcfg, jparams,
                              {"tokens": jnp.asarray(tk[:, :100])},
                              window=WINDOW)
    return tk, forward, last, cache


def _close(got, want, frac):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= frac * np.abs(want).max()


def test_windowed_ssd_prefill_matches_jax(zamba, run):
    _, cfg, _, params = zamba
    tk, forward, want, jcache = run
    got, cache = lm.prefill(cfg, params, {"tokens": T(tk[:, :100])},
                            window=WINDOW)
    _close(got.numpy(), want, 1e-4)
    np.testing.assert_allclose(got.numpy(), forward[:, 99], atol=2e-4)
    jl = jax.tree.leaves(jcache)
    tl = [x for e in sp.tree_leaves(cache) if e is not None for x in e]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(b.numpy(), a, 1e-3)
    # The window bites: the same prompt without it gives other logits.
    full, _ = lm.prefill(cfg, params, {"tokens": T(tk[:, :100])})
    assert float((full - got).abs().max()) > 1e-3 * float(got.abs().max())


def test_decode_on_the_ring_matches_jax(zamba, run):
    """A 64-token windowed prefill is the ring of ``cache_len_for``'s
    long_500k cell (64 slots at window 64); 8 decode steps wrap it from
    the first (slot pos % 64), against JAX's ``decode_step`` on the same
    ring (whose mask over a full ring is the window) and against JAX's
    windowed forward at each position."""
    jcfg, cfg, jparams, params = zamba
    tk, forward, _, _ = run
    slots = lm.cache_len_for(cfg, C.SHAPES["long_500k"])
    assert slots == jlm.cache_len_for(jcfg, JC.SHAPES["long_500k"]) == WINDOW
    s, steps = WINDOW, 8
    _, jcache = jlm.prefill(jcfg, jparams, {"tokens": jnp.asarray(tk[:, :s])},
                            window=WINDOW)
    _, cache = lm.prefill(cfg, params, {"tokens": T(tk[:, :s])},
                          window=WINDOW)
    kv = cache["pos5"]["kv"]
    assert kv.k.shape[-2] == slots
    jdecode = jax.jit(lambda p, tok, c, pos: jlm.decode(jcfg, p, tok, c, pos))
    for pos in range(s, s + steps):
        want, jcache = jdecode(jparams, jnp.asarray(tk[:, pos]), jcache,
                               jnp.asarray(pos, jnp.int32))
        before = kv.k[:, :, :, pos % slots].clone()
        got, cache = lm.decode(cfg, params, T(tk[:, pos]), cache, pos,
                               window=WINDOW)
        assert not torch.equal(kv.k[:, :, :, pos % slots], before)
        _close(got.numpy(), want, 1e-4)
        np.testing.assert_allclose(got.numpy(), forward[:, pos], atol=5e-4)


def test_windowed_decode_over_a_padded_cache(zamba, run):
    """A 100-token windowed prefill padded to 104 slots: each windowed
    decode step sees the last 64 positions, as JAX's windowed forward
    does.  JAX's own ``decode_step`` takes ``window`` and drops it
    (``repro/models/transformer.py:256``), so over the padded cache it
    attends to every cached key and differs; the port passes it on."""
    jcfg, cfg, jparams, params = zamba
    tk, forward, _, jcache = run
    s, steps = 100, 4
    _, cache = lm.prefill(cfg, params, {"tokens": T(tk[:, :s])},
                          window=WINDOW)
    cache = lm.pad_cache(cfg, cache, s + steps)
    jdec, _ = jtfm.decode_step(jcfg, jparams, jnp.asarray(tk[:, s]),
                               jlm.pad_cache(jcfg, jcache, s + steps),
                               jnp.asarray(s, jnp.int32), None,
                               window=WINDOW)
    assert np.abs(np.asarray(jdec) - forward[:, s]).max() > 1e-2
    for pos in range(s, s + steps):
        got, cache = tfm.decode_step(cfg, params, T(tk[:, pos]), cache, pos,
                                     window=WINDOW)
        np.testing.assert_allclose(got.numpy(), forward[:, pos], atol=5e-4)
