"""Port parity, the LM serving slice: configs, parameter trees, layers,
attention, the Mamba-2 and Mamba-1 blocks and the whole model
(``prefill``, ``decode``, a greedy serve) against the JAX package on the
CPU, on the reduced zamba2-2.7b (hybrid, GQA 4 over 2 heads),
internlm2-1.8b (dense) and falcon-mamba-7b (Mamba-1, attention-free:
d_model 64, d_inner 128, N 16, dt_rank 4) configs in float32, from the
same weights (``convert.lm_params_from_jax``).  falcon-mamba's A_log is
Mamba-1's published initialisation, A[d, n] = -(n + 1) (``general_a``),
not the reference's zeros, so that no row of A is constant and the scan
takes its general route.

On the CPU the prefill runs the plain versions of the flash-attention and
ssm_scan kernels where the JAX model runs ``chunked_attention`` and
``scan_chunked``.  Tolerances: prefill logits within 2e-4 and a decode
step within 5e-4 (the JAX package's own prefill/decode consistency
bounds; the sums run in another order and ``exp`` differs in the last
bits), layers within 1e-5, the prefill caches within 1e-3 of each leaf's
largest |value|.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jly  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import spec as jsp  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import common as kc  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers as ly  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mlp  # noqa: E402
from repro_torch.models import spec as sp  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

# The config, spec and init cases take every arch; the model-level cases
# of the MoE archs, whisper and the last dense archs are in
# tests/test_torch_moe.py, tests/test_torch_whisper.py and
# tests/test_torch_dense.py.
ARCHS = ["zamba2-2.7b", "internlm2-1.8b", "falcon-mamba-7b",
         "granite-moe-1b-a400m", "llama4-maverick-400b-a17b",
         "whisper-medium", "llama3-8b", "yi-9b", "mistral-nemo-12b",
         "chameleon-34b"]
MODEL_ARCHS = ["zamba2-2.7b", "internlm2-1.8b", "falcon-mamba-7b"]
ATTN_ARCHS = [a for a in MODEL_ARCHS if a != "falcon-mamba-7b"]
CPU = "cpu"


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def general_a(a_log):
    """Mamba-1's published A ("S4D real": A[d, n] = -(n + 1), so A_log[d,
    n] = log(n + 1); state-spaces/mamba, ``mamba_simple.py``) in the shape
    and type of the JAX leaf ``a_log`` [..., di, N]."""
    n = a_log.shape[-1]
    row = jnp.log(jnp.arange(1, n + 1, dtype=jnp.float32))
    return jnp.broadcast_to(row, a_log.shape).astype(a_log.dtype)


def with_general_a(jcfg, jparams):
    """The JAX parameters with every Mamba-1 layer's A_log set by
    :func:`general_a` (Mamba-2 and attention parameters unchanged)."""
    if jcfg.ssm_version != 1 or not jcfg.ssm_state:
        return jparams
    return jax.tree_util.tree_map_with_path(
        lambda path, x: general_a(x) if path[-1].key == "A_log" else x,
        jparams)


def _model(arch):
    jcfg = JC.get(arch).reduced()
    cfg = C.get(arch).reduced()
    jparams = with_general_a(jcfg, jlm.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, jparams, convert.lm_params_from_jax(jparams, device=CPU)


@pytest.fixture(scope="module", params=MODEL_ARCHS)
def model(request):
    """(jax cfg, port cfg, jax params, port params) of a reduced arch."""
    return _model(request.param)


@pytest.fixture(scope="module", params=ATTN_ARCHS)
def attn_model(request):
    """:func:`model` of the archs with attention."""
    return _model(request.param)


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# Configs and parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_jax_package(arch):
    for reduce in (False, True):
        j, t = JC.get(arch), C.get(arch)
        if reduce:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.pattern_period() == j.pattern_period()
        assert (t.d_inner, t.n_ssm_heads) == (j.d_inner, j.n_ssm_heads)


def test_unported_archs_raise():
    """Every arch of the JAX package is ported, in its order; an unknown
    one raises ``KeyError``."""
    assert C.ARCH_IDS == JC.ARCH_IDS
    for arch in JC.ARCH_IDS:
        assert C.get(arch).name == arch
    with pytest.raises(KeyError):
        C.get("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_tree_matches_the_jax_package(arch):
    """Same keys, shapes, init rules and fan-ins, at full width."""
    j, t = jlm.model_spec(JC.get(arch)), lm.model_spec(C.get(arch))
    jleaves, _ = jax.tree.flatten(j, is_leaf=lambda x: isinstance(
        x, jsp.ParamSpec))
    tleaves = sp.tree_leaves(t)
    assert [tuple(x) for x in tleaves] == [tuple(x) for x in jleaves]
    assert sp.count_params(t) == jsp.count_params(j)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, j, is_leaf=lambda x:
                                           isinstance(x, jsp.ParamSpec))) == \
        jax.tree.structure(sp.tree_map(lambda _: 0, t))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_spec(arch):
    cfg = C.get(arch).reduced()
    params = lm.init(torch.Generator().manual_seed(0), cfg, device=CPU)
    specs = sp.tree_leaves(lm.model_spec(cfg))
    for spec, x in zip(specs, sp.tree_leaves(params)):
        assert tuple(x.shape) == spec.shape and x.dtype == torch.float32
        if spec.init == "zeros":
            assert not x.any()
        elif spec.init == "ones":
            assert bool((x == 1).all())
        elif x.numel() >= 4096:
            want = 0.02 if spec.init == "small_normal" else spec.scale()
            assert abs(float(x.std()) / want - 1) < 0.1
    again = lm.init(torch.Generator().manual_seed(0), cfg, device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(sp.tree_leaves(params),
                                                 sp.tree_leaves(again)))


def test_lm_params_from_jax_round_trip(model):
    _, _, jparams, params = model
    jl, _ = jax.tree.flatten(jparams)
    tl = sp.tree_leaves(params)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_lm_params_from_jax_keeps_bf16():
    rng = np.random.default_rng(0)
    tree = {"a": {"w": jnp.asarray(rng.standard_normal((4, 3)), jnp.bfloat16)},
            "b": jnp.arange(5, dtype=jnp.int32)}
    out = convert.lm_params_from_jax(tree, device=CPU)
    assert out["a"]["w"].dtype == torch.bfloat16
    assert out["b"].dtype == torch.int32
    np.testing.assert_array_equal(out["a"]["w"].float().numpy(),
                                  np.asarray(tree["a"]["w"], np.float32))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = jly.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), kind=kind, eps=1e-5)
    got = ly.apply_norm({k: T(v) for k, v in p.items()}, T(x), kind=kind,
                        eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_apply_rope_rotates_halves():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(40, 47)]).astype(np.int32)
    want = jly.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = ly.apply_rope(T(x), T(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(ly.rope_frequencies(16, 1e4).numpy(),
                               np.asarray(jly.rope_frequencies(16, 1e4)),
                               rtol=1e-6)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp(act):
    jcfg = dataclasses.replace(JC.get("internlm2-1.8b").reduced(), act=act)
    cfg = dataclasses.replace(C.get("internlm2-1.8b").reduced(), act=act)
    jp = jsp.init_tree(jax.random.PRNGKey(3), jmlp.mlp_spec(jcfg),
                       jnp.float32)
    if act == "gelu":  # non-zero biases
        jp = dict(jp, b_up=jp["b_up"] + 0.1, b_down=jp["b_down"] - 0.2)
    x = np.random.default_rng(3).standard_normal((2, 5, 64)).astype(
        np.float32)
    want = jmlp.mlp_apply(jcfg, jp, jnp.asarray(x), None)
    got = mlp.mlp_apply(cfg, convert.lm_params_from_jax(jp, device=CPU),
                        T(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_softplus_is_logaddexp():
    x = np.array([-50.0, -3.0, 0.0, 0.5, 19.0, 21.0, 40.0, 90.0], np.float32)
    np.testing.assert_allclose(ssm.softplus(T(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# Attention and the Mamba blocks
# ---------------------------------------------------------------------------

def _block_params(model, pos):
    jcfg, cfg, jparams, params = model
    jbp = jax.tree.map(lambda x: x[0], jparams["blocks"][pos])
    bp = sp.tree_map(lambda x: x[0], params["blocks"][pos])
    return jbp, bp


def test_project_qkv_and_decode_attention(attn_model):
    jcfg, cfg, jparams, params = attn_model
    if jcfg.family == "hybrid":
        jbp, bp = jparams["shared"], params["shared"]
    else:
        jbp, bp = _block_params(attn_model, "pos0")
    rng = np.random.default_rng(4)
    b, s = 2, 9
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jq, jk, jv = jattn.project_qkv(jcfg, jbp["attn"], jnp.asarray(x),
                                   jnp.asarray(x), None, jnp.asarray(pos),
                                   jnp.asarray(pos), use_rope=True)
    q, k, v = attn.project_qkv(cfg, bp["attn"], T(x), T(x), T(pos), T(pos),
                               use_rope=True)
    for g, w in ((q, jq), (k, jk), (v, jv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    o = rng.standard_normal((b, cfg.n_heads, s, cfg.d_head)).astype(
        np.float32)
    np.testing.assert_allclose(
        attn.output_proj(bp["attn"], T(o)).numpy(),
        np.asarray(jattn.output_proj(jbp["attn"], jnp.asarray(o), None)),
        atol=1e-5)
    cache_k = rng.standard_normal((b, cfg.n_kv_heads, 12, cfg.d_head))
    cache_v = rng.standard_normal((b, cfg.n_kv_heads, 12, cfg.d_head))
    q1 = rng.standard_normal((b, cfg.n_heads, 1, cfg.d_head))
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    want = jattn.decode_attention(
        jnp.asarray(f32(q1)), jattn.KVCache(k=jnp.asarray(f32(cache_k)),
                                            v=jnp.asarray(f32(cache_v))), 7)
    got = attn.decode_attention(
        T(f32(q1)), attn.KVCache(k=T(f32(cache_k)), v=T(f32(cache_v))), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_ssm_block_prefill_and_decode():
    jcfg = JC.get("zamba2-2.7b").reduced()
    cfg = C.get("zamba2-2.7b").reduced()
    jp = jsp.init_tree(jax.random.PRNGKey(5), jssm.ssm_spec(jcfg),
                       jnp.float32)
    # Non-trivial conv bias, A and dt bias.
    jp = dict(jp, conv_b=jp["conv_b"] + 0.05, A_log=jp["A_log"] + 0.3,
              dt_bias=jp["dt_bias"] - 0.5)
    p = convert.lm_params_from_jax(jp, device=CPU)
    x = np.random.default_rng(6).standard_normal((2, 11, cfg.d_model))
    x = x.astype(np.float32)
    xj = jnp.asarray(x)
    np.testing.assert_allclose(
        ssm._conv1d(p, T(x[..., :1]).expand(2, 11, cfg.d_inner)).numpy(),
        np.asarray(jssm._conv1d(jp, jnp.broadcast_to(
            xj[..., :1], (2, 11, cfg.d_inner)))), atol=1e-6)
    want, jstate = jssm.ssm_apply(jcfg, jp, xj, None, return_state=True)
    got, state = ssm.ssm_apply(cfg, p, T(x), return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(state.h.numpy(), np.asarray(jstate.h),
                               atol=1e-5)
    np.testing.assert_allclose(state.conv.numpy(), np.asarray(jstate.conv),
                               atol=1e-6)
    x1 = np.random.default_rng(7).standard_normal((2, 1, cfg.d_model))
    x1 = x1.astype(np.float32)
    jy, jst = jssm.ssm_decode(jcfg, jp, jnp.asarray(x1), jstate, None)
    y, st = ssm.ssm_decode(cfg, p, T(x1), state)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(st.h.numpy(), np.asarray(jst.h), atol=1e-5)
    np.testing.assert_allclose(st.conv.numpy(), np.asarray(jst.conv),
                               atol=1e-6)


def test_mamba1_block_prefill_and_decode():
    """falcon-mamba's block (Mamba-1): ``dt_rank``, the spec's leaves,
    ``_dt_bc`` (the low-rank dt, B and C from x_conv, A [di, N]),
    ``ssm_apply`` with its final state over 70 steps (a ragged second
    chunk of checkpoints) and a ``ssm_decode`` step, each against
    ``repro.models.ssm`` with A_log from :func:`general_a`."""
    jcfg = JC.get("falcon-mamba-7b").reduced()
    cfg = C.get("falcon-mamba-7b").reduced()
    assert ssm.dt_rank(cfg) == jssm.dt_rank(jcfg) == 4
    assert ssm.dt_rank(C.get("falcon-mamba-7b")) == 256
    spec = ssm.ssm_spec(cfg)
    jspec = jssm.ssm_spec(jcfg)
    assert sorted(spec) == sorted(jspec)
    for k, v in jspec.items():
        assert (spec[k].shape, spec[k].axes, spec[k].init) == (
            v.shape, v.axes, v.init), k
    jp = jsp.init_tree(jax.random.PRNGKey(8), jspec, jnp.float32)
    jp = dict(jp, conv_b=jp["conv_b"] + 0.05, A_log=general_a(jp["A_log"]),
              dt_bias=jp["dt_bias"] - 0.5)
    p = convert.lm_params_from_jax(jp, device=CPU)
    rng = np.random.default_rng(9)
    b, t = 2, 70
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    xc = rng.standard_normal((b, t, cfg.d_inner)).astype(np.float32)
    want = jssm._dt_bc(jcfg, jp, jnp.asarray(x), jnp.asarray(xc))
    got = ssm._dt_bc(cfg, p, T(x), T(xc))
    assert want[4] is None and want[5] is None
    for g, w in zip(got, want[:4]):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    assert not bool((got[3] == got[3][:, :1]).all(1).any())  # no constant row
    xj = jnp.asarray(x)
    want, jstate = jssm.ssm_apply(jcfg, jp, xj, None, return_state=True)
    out, state = ssm.ssm_apply(cfg, p, T(x), return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(state.h.numpy(), np.asarray(jstate.h),
                               atol=1e-5)
    np.testing.assert_allclose(state.conv.numpy(), np.asarray(jstate.conv),
                               atol=1e-6)
    x1 = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    jy, jst = jssm.ssm_decode(jcfg, jp, jnp.asarray(x1), jstate, None)
    y, st = ssm.ssm_decode(cfg, p, T(x1), state)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(st.h.numpy(), np.asarray(jst.h), atol=1e-5)
    np.testing.assert_allclose(st.conv.numpy(), np.asarray(jst.conv),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

def test_prefill_matches_jax(model):
    jcfg, cfg, jparams, params = model
    tk = _tokens(cfg, 2, 24)
    want, jcache = jlm.prefill(jcfg, jparams, {"tokens": jnp.asarray(tk)})
    got, cache = lm.prefill(cfg, params, {"tokens": T(tk)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    # The caches, leaf by leaf (KV [R, B, H, S, D], SSM h and conv tail),
    # within 1e-3 of each leaf's largest |value|: the residual stream, and
    # with it k, v and h, grows over the layers while the rounding
    # differences add up.
    jl = jax.tree.leaves(jcache)
    tl = [x for e in sp.tree_leaves(cache) if e is not None for x in e]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape
        assert np.abs(b.numpy() - a).max() <= 1e-3 * max(1.0, np.abs(a).max())


def test_decode_step_matches_jax(model):
    jcfg, cfg, jparams, params = model
    s = 20
    tk = _tokens(cfg, 2, s + 1, seed=1)
    _, jcache = jlm.prefill(jcfg, jparams, {"tokens": jnp.asarray(tk[:, :s])})
    _, cache = lm.prefill(cfg, params, {"tokens": T(tk[:, :s])})
    jcache = jlm.pad_cache(jcfg, jcache, s + 4)
    cache = lm.pad_cache(cfg, cache, s + 4)
    want, _ = jlm.decode(jcfg, jparams, jnp.asarray(tk[:, s]), jcache,
                         jnp.asarray(s, jnp.int32))
    before = [x.clone() for e in cache.values() if e["ssm"] is not None
              for x in e["ssm"]]
    got, cache = lm.decode(cfg, params, T(tk[:, s]), cache, s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)
    kv = [e["kv"] for e in cache.values() if e["kv"] is not None]
    if cfg.family == "ssm":   # no attention: no KV entry at all
        assert not kv
    else:
        assert kv[0].k.shape[-2] == s + 4 and bool(kv[0].k[:, :, :, s].any())
    # The step moved every SSM state and conv tail in place.
    after = [x for e in cache.values() if e["ssm"] is not None
             for x in e["ssm"]]
    assert len(after) == len(before)
    assert all(not torch.equal(a, b) for a, b in zip(after, before))


def test_greedy_serve_gives_equal_tokens(model):
    """4 greedy steps after a prefill: the same tokens as JAX."""
    jcfg, cfg, jparams, params = model
    b, s, steps = 2, 16, 4
    tk = _tokens(cfg, b, s, seed=2)
    jlg, jcache = jlm.prefill(jcfg, jparams, {"tokens": jnp.asarray(tk)})
    lg, cache = lm.prefill(cfg, params, {"tokens": T(tk)})
    jcache = jlm.pad_cache(jcfg, jcache, s + steps)
    cache = lm.pad_cache(cfg, cache, s + steps)
    jids, ids = [], []
    for i in range(steps):
        jtok = jnp.argmax(jlg, axis=-1).astype(jnp.int32)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        jids.append(np.asarray(jtok))
        ids.append(tok.numpy())
        jlg, jcache = jlm.decode(jcfg, jparams, jtok, jcache,
                                 jnp.asarray(s + i, jnp.int32))
        lg, cache = lm.decode(cfg, params, tok, cache, s + i)
    np.testing.assert_array_equal(np.stack(ids), np.stack(jids))


def test_serve_consistency(model):
    """prefill + decode equals the full forward at the next position (the
    port's own, as ``tests/test_models_smoke.py`` checks the JAX
    model)."""
    _, cfg, _, params = model
    b, s = 2, 16
    tk = T(_tokens(cfg, b, s + 1, seed=3))
    full = tfm.forward(cfg, params, tk)
    last, cache = lm.prefill(cfg, params, {"tokens": tk[:, :s]})
    np.testing.assert_allclose(last.numpy(), full.logits[:, s - 1].numpy(),
                               atol=2e-4)
    cache = lm.pad_cache(cfg, cache, s + 4)
    dec, _ = lm.decode(cfg, params, tk[:, s], cache, s)
    np.testing.assert_allclose(dec.numpy(), full.logits[:, s].numpy(),
                               atol=5e-4)


def test_make_cache_matches_jax(model):
    jcfg, cfg, _, _ = model
    jc = jlm.make_cache(jcfg, 2, 10)
    tc = lm.make_cache(cfg, 2, 10, device=CPU)
    jl = jax.tree.leaves(jc)
    tl = [x for e in sp.tree_leaves(tc) if e is not None for x in e]
    assert [tuple(x.shape) for x in tl] == [x.shape for x in jl]
    assert all(not x.any() for x in tl)
    # No zero-size leaf: an attention-free model has no KV entry at all.
    assert all(x.numel() > 0 for x in tl)
    has_kv = [e["kv"] is not None for e in tc.values()]
    assert any(has_kv) == (cfg.attn_layers > 0)


def test_launches_stay_zero_on_the_cpu(model):
    _, cfg, _, params = model
    kc.reset_launches()
    lm.prefill(cfg, params, {"tokens": T(_tokens(cfg, 1, 8))})
    assert kc.launches["flash_attention"] == 0
    assert kc.launches["ssm_scan"] == 0
