"""Port parity, the encoder-decoder slice: reduced whisper-medium (2
encoder and 2 decoder layers, d_model 64, 4 query heads over 2 KV heads,
float32) against ``repro.models.whisper`` and ``repro.models.lm`` on the
CPU, from the same weights (``convert.lm_params_from_jax``), inputs drawn
from numpy seeds.

On the CPU the flash-attention Function runs its plain versions where the
JAX model runs ``chunked_attention``: without the causal mask in the
encoder and the cross-attention, causal in the decoder's self-attention.

Tolerances: the sinusoid table within 1e-6 plus pos x 2^-22 (``exp``
differs in the last bit between PyTorch and XLA, and the angle
pos x rate multiplies a one-ulp difference of the rate by the position);
``encode`` within 1e-5; ``forward``'s logits within 2e-4 of the largest
|logit|; ``loss_fn`` within 1e-5 relative and every gradient within 1e-5
of its leaf's largest |g|, remat on and off; prefill within 2e-4 and
each decode step within 5e-4 (the JAX package's own prefill/decode
bounds, as ``tests/test_torch_lm.py`` holds the decoder-only archs).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.models import layers as jly  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import spec as jsp  # noqa: E402
from repro.models import whisper as jwsp  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import common as kc  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import layers as ly  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import spec as sp  # noqa: E402
from repro_torch.models import whisper as wsp  # noqa: E402

ARCH = "whisper-medium"
CPU = "cpu"
B, S_ENC, S_TOK = 2, 20, 16


def T(x):
    return torch.as_tensor(np.array(x))


def _inputs(cfg, b, s_enc, s_tok, seed=0):
    """Frames [b, s_enc, d_model] float32 and tokens [b, s_tok + 1]."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, s_enc, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b, s_tok + 1)).astype(np.int32)
    return frames, tokens


@pytest.fixture(scope="module")
def model():
    """(jax cfg, port cfg, jax params, port params, JAX results): the
    encoder's output and the forward's logits on [2, 20] frames and [2,
    16] tokens, and ``loss_fn``'s loss and gradients (one ``jax.jit`` of
    ``value_and_grad``, remat on, the reference's default)."""
    jcfg, cfg = JC.get(ARCH).reduced(), C.get(ARCH).reduced()
    jp = jlm.init(jax.random.PRNGKey(0), jcfg)
    frames, tokens = _inputs(cfg, B, S_ENC, S_TOK)
    fr, tk = jnp.asarray(frames), jnp.asarray(tokens)
    enc = jwsp.encode(jcfg, jp, fr, None)
    fwd = jwsp.forward(jcfg, jp, fr, tk[:, :-1], None)
    batch = {"frames": fr, "tokens": tk[:, :-1], "targets": tk[:, 1:]}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, batch), has_aux=True))(jp)
    want = dict(frames=frames, tokens=tokens, enc=np.asarray(enc),
                logits=np.asarray(fwd.logits), loss=float(loss),
                grads=[np.asarray(g) for g in jax.tree.leaves(grads)])
    return jcfg, cfg, jp, convert.lm_params_from_jax(jp, device=CPU), want


# ---------------------------------------------------------------------------
# The spec, the weights and the sinusoid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduce", [False, True])
def test_spec_tree_matches_the_jax_package(reduce):
    """Same leaf paths, shapes, init rules and fan-ins; the parameter
    count in the range ``tests/test_models_smoke.py`` gives whisper."""
    jcfg, cfg = JC.get(ARCH), C.get(ARCH)
    if reduce:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    j, t = jlm.model_spec(jcfg), lm.model_spec(cfg)
    is_spec = lambda x: isinstance(x, jsp.ParamSpec)  # noqa: E731
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(j, is_leaf=is_spec)[0]]
    tpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_flatten_with_path(
                  sp.tree_map(lambda s: 0, t))[0]]
    assert tpaths == jpaths
    jleaves = jax.tree.leaves(j, is_leaf=is_spec)
    assert [tuple(x) for x in sp.tree_leaves(t)] == [tuple(x)
                                                      for x in jleaves]
    n = sp.count_params(t)
    assert n == jsp.count_params(j)
    if not reduce:
        assert 0.6e9 <= n <= 1.0e9


def test_lm_params_from_jax_carries_the_whisper_tree(model):
    """Every leaf of the whisper tree comes across, in order, bitwise,
    with the tree's keys."""
    _, _, jp, params, _ = model
    assert sorted(params) == sorted(jp) == [
        "dec_blocks", "embed", "enc_blocks", "enc_final_norm", "final_norm"]
    jl = jax.tree.leaves(jp)
    tl = sp.tree_leaves(params)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seq,d", [(12, 64), (300, 64), (448, 1024)])
def test_sinusoidal_positions_match_jax(seq, d):
    want = np.asarray(jly.sinusoidal_positions(seq, d))
    got = ly.sinusoidal_positions(seq, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    pos = np.arange(seq, dtype=np.float64)[:, None]
    assert bool((np.abs(got.numpy() - want) <= 1e-6 + pos * 2**-22).all())


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def test_encode_matches_jax(model):
    _, cfg, _, params, want = model
    with torch.no_grad():
        got = wsp.encode(cfg, params, T(want["frames"]))
    np.testing.assert_allclose(got.numpy(), want["enc"], rtol=0, atol=1e-5)


def test_forward_logits_match_jax(model):
    _, cfg, _, params, want = model
    with torch.no_grad():
        out = wsp.forward(cfg, params, T(want["frames"]),
                          T(want["tokens"][:, :-1]))
    assert out.metrics == {} and out.cache is None
    np.testing.assert_allclose(out.logits.numpy(), want["logits"], rtol=0,
                               atol=2e-4 * np.abs(want["logits"]).max())


def _port_grads(cfg, params, want, remat):
    p = sp.tree_map(lambda x: x.detach().clone().requires_grad_(True),
                    params)
    tk = T(want["tokens"])
    batch = {"frames": T(want["frames"]), "tokens": tk[:, :-1],
             "targets": tk[:, 1:]}
    loss, metrics = lm.loss_fn(cfg, p, batch, remat=remat)
    return loss.detach(), metrics, torch.autograd.grad(loss,
                                                       sp.tree_leaves(p))


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_gradient_match_jax(model, remat):
    _, cfg, _, params, want = model
    loss, metrics, grads = _port_grads(cfg, params, want, remat)
    assert set(metrics) == {"ce_loss", "loss"}
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)
    assert len(grads) == len(want["grads"])
    for w, g in zip(want["grads"], grads):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


def test_remat_gives_bitwise_equal_gradients(model):
    """Each block recomputed whole gives the bits of ``remat=False``."""
    _, cfg, _, params, want = model
    ref = _port_grads(cfg, params, want, remat=False)
    got = _port_grads(cfg, params, want, remat=True)
    assert torch.equal(got[0], ref[0])
    for a, b in zip(got[2], ref[2]):
        assert torch.equal(a, b)


def test_prefill_then_decode_match_jax(model):
    """Prefill over 8 tokens and 20 frames, ``pad_cache`` to 12 slots (the
    cross cache stays at 20), then 4 teacher-forced decode steps: the
    prefill within 2e-4, each step within 5e-4, the caches' shapes
    JAX's."""
    jcfg, cfg, jp, params, want = model
    frames, tokens = want["frames"], want["tokens"]
    s, steps = 8, 4
    jbatch = {"frames": jnp.asarray(frames),
              "tokens": jnp.asarray(tokens[:, :s])}
    jlast, jcache = jlm.prefill(jcfg, jp, jbatch)
    jcache = jlm.pad_cache(jcfg, jcache, s + steps)
    with torch.no_grad():
        last, cache = lm.prefill(cfg, params, {
            "frames": T(frames), "tokens": T(tokens[:, :s])})
        cache = lm.pad_cache(cfg, cache, s + steps)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=2e-4)
    assert {k: tuple(v.k.shape) for k, v in cache.items()} == {
        k: tuple(v.k.shape) for k, v in jcache.items()} == {
        "self": (2, B, 2, s + steps, 16), "cross": (2, B, 2, S_ENC, 16)}
    for i in range(steps):
        jlg, jcache = jlm.decode(jcfg, jp, jnp.asarray(tokens[:, s + i]),
                                 jcache, jnp.asarray(s + i, jnp.int32))
        with torch.no_grad():
            lg, cache = lm.decode(cfg, params, T(tokens[:, s + i]), cache,
                                  s + i)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=5e-4)
    assert bool(cache["self"].k[:, :, :, s + steps - 1].any())


def test_prefill_and_decode_agree_with_the_forward(model):
    """prefill + one decode step equal the full forward at positions S - 1
    and S, as ``tests/test_models_smoke.py`` checks the JAX model."""
    _, cfg, _, params, want = model
    fr, tk = T(want["frames"]), T(want["tokens"])
    s = 10
    with torch.no_grad():
        full = wsp.forward(cfg, params, fr, tk[:, :s + 1]).logits
        last, cache = lm.prefill(cfg, params, {"frames": fr,
                                               "tokens": tk[:, :s]})
        cache = lm.pad_cache(cfg, cache, s + 1)
        dec, _ = lm.decode(cfg, params, tk[:, s], cache, s)
    np.testing.assert_allclose(last.numpy(), full[:, s - 1].numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(dec.numpy(), full[:, s].numpy(), atol=5e-4)


def test_pad_cache_pads_the_cross_cache_as_the_reference(model):
    """The reference's rule: ``pad_cache`` grows every KV cache shorter
    than ``s_max``, the cross cache too, and ``decode_step`` then attends
    over the zero keys past the frames.  With 12 frames and ``s_max`` 20
    the port's decode step equals JAX's, and both differ from the full
    forward at that position (which sees only the 12 frames)."""
    jcfg, cfg, jp, params, want = model
    frames, tokens = want["frames"][:, :12], want["tokens"]
    s, s_max = 8, 20
    _, jcache = jlm.prefill(jcfg, jp, {"frames": jnp.asarray(frames),
                                       "tokens": jnp.asarray(tokens[:, :s])})
    jcache = jlm.pad_cache(jcfg, jcache, s_max)
    jdec, _ = jlm.decode(jcfg, jp, jnp.asarray(tokens[:, s]), jcache,
                         jnp.asarray(s, jnp.int32))
    with torch.no_grad():
        _, cache = lm.prefill(cfg, params, {"frames": T(frames),
                                            "tokens": T(tokens[:, :s])})
        cache = lm.pad_cache(cfg, cache, s_max)
        dec, _ = lm.decode(cfg, params, T(tokens[:, s]), cache, s)
        full = wsp.forward(cfg, params, T(frames),
                           T(tokens[:, :s + 1])).logits[:, s]
    assert tuple(cache["cross"].k.shape) == (2, B, 2, s_max, 16)
    assert tuple(jcache["cross"].k.shape) == (2, B, 2, s_max, 16)
    assert not bool(cache["cross"].k[:, :, :, 12:].any())
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=5e-4)
    assert float((dec - full).abs().max()) > 1e-2
    assert float(np.abs(np.asarray(jdec) - full.numpy()).max()) > 1e-2


def test_make_cache_shapes_match_jax():
    """Zero caches with ``enc_s``: the self cache of ``s_max`` slots, the
    cross cache of ``enc_s`` frames (``s_max`` where 0), as JAX's."""
    jcfg, cfg = JC.get(ARCH).reduced(), C.get(ARCH).reduced()
    for enc_s in (30, 0):
        want = jlm.make_cache(jcfg, 3, 12, enc_s=enc_s)
        got = lm.make_cache(cfg, 3, 12, enc_s=enc_s, device=CPU)
        assert sorted(got) == sorted(want) == ["cross", "self"]
        for key in got:
            for x, w in zip(got[key], want[key]):
                assert tuple(x.shape) == w.shape
                assert x.dtype == torch.float32 and not bool(x.any())


def test_lm_init_builds_an_encoder_decoder():
    """``lm.init`` on an encoder-decoder config (a dense config given
    encoder layers builds the whisper tree): leaves drawn from the spec."""
    dense = C.get("internlm2-1.8b").reduced()
    for cfg in (dataclasses.replace(dense, encoder_layers=2, act="gelu",
                                    norm="layernorm"),
                C.get(ARCH).reduced()):
        params = lm.init(torch.Generator().manual_seed(0), cfg, device=CPU)
        specs = sp.tree_leaves(wsp.encdec_spec(cfg))
        leaves = sp.tree_leaves(params)
        assert len(leaves) == len(specs)
        for spec, x in zip(specs, leaves):
            assert tuple(x.shape) == spec.shape
        assert params["enc_blocks"]["blk"]["attn"]["wq"].shape[0] == 2


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------

def test_serve_runs_whisper_on_the_cpu(capsys):
    """``launch.serve`` on reduced whisper-medium with ``--device cpu``
    (the call that raised before this slice): 32 frames, 8 prompt tokens,
    ids in range, the reference's three lines, no kernel launched."""
    kc.reset_launches()
    ids = serve.main(["--device", "cpu", "--arch", ARCH, "--reduced"])
    assert ids.shape == (4, 16) and ids.dtype == torch.int32
    assert bool(((ids >= 0) & (ids < 256)).all())
    out = capsys.readouterr().out
    assert "prefill: 4x8 in" in out and "decode: 16 steps x batch 4" in out
    assert "sample output ids:" in out
    assert not any(kc.launches.values())


def test_train_runs_whisper_on_the_cpu(capsys, tmp_path):
    """``launch.train`` on reduced whisper-medium: 16 frames and 448
    decoder tokens a row, finite loss and grad norm on every step line."""
    train.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps",
                "2", "--batch", "2", "--seq", "16", "--log-every", "1",
                "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("step")]
    assert len(lines) == 2 and out.rstrip().endswith("done")
    for ln in lines:
        loss, gnorm = float(ln.split()[3]), float(ln.split()[5])
        assert np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0
