"""Port parity, the last dense architectures: llama3-8b, yi-9b,
mistral-nemo-12b and chameleon-34b (layernorm), the config registry of
all ten archs, and the sliced initialiser, against the JAX package on
the CPU.

The four reduced configs share d_model 64 and 4 heads of 16, so two small
configs that ``reduced()`` cannot give go through the same checks, built
with ``dataclasses.replace`` on the reference's config and the port's
alike: ``wide-model`` (mistral-nemo's case: d_model 80 over 4 heads of 16,
so n_heads x d_head is not d_model) and ``group-8`` (yi-9b's and
chameleon's GQA group: 8 query heads over 1 KV head).  Weights are the
reference's initialiser's, carried across with
``convert.lm_params_from_jax``; tokens come from numpy with a seed.

Tolerances, as in ``tests/test_torch_lm.py`` and
``tests/test_torch_train.py``: prefill logits within 2e-4 and a decode
step within 5e-4 (the JAX package's own prefill/decode consistency
bounds; the sums run in another order and ``exp`` differs in the last
bits); the loss within 1e-5 relative and every gradient within 1e-5 of
its leaf's largest |g| (float32 sums in another order).

The initialiser: every float32 allocation of ``init_tree`` is recorded
(a ``TorchDispatchMode``): none may exceed one block of ``DRAW_ELEMS``
(one slice of a stacked leaf, or a block of its rows); a seed fixes every
weight, the slices of a stacked leaf differ, each drawn leaf of at least
1e6 elements has its standard deviation within 2% of its rule's, and
``zeros`` / ``ones`` leaves are exact.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import spec as jsp  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import spec as sp  # noqa: E402

DENSE = ["llama3-8b", "yi-9b", "mistral-nemo-12b", "chameleon-34b"]
CPU = "cpu"


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _small(name: str, ref: bool):
    """The two configs ``reduced()`` cannot give, from the package's own
    reduced config (``ref``: the reference's)."""
    get = JC.get if ref else C.get
    if name == "wide-model":
        return dataclasses.replace(get("mistral-nemo-12b").reduced(),
                                   name="wide-model", d_model=80)
    return dataclasses.replace(get("yi-9b").reduced(), name="group-8",
                               n_heads=8, n_kv_heads=1, d_head=8)


def _configs(name: str):
    """(JAX config, port config) of a model of this file."""
    if name in DENSE:
        return JC.get(name).reduced(), C.get(name).reduced()
    return _small(name, ref=True), _small(name, ref=False)


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_every_arch_config_equals_the_references(arch):
    for reduce in (False, True):
        j, t = JC.get(arch), C.get(arch)
        if reduce:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.pattern_period() == j.pattern_period()
        assert t.attn_layers == j.attn_layers


def test_arch_registry_complete():
    """The reference's ``test_arch_registry_complete`` on the port."""
    assert C.ARCH_IDS == JC.ARCH_IDS and len(C.ARCH_IDS) == 10
    for aid in C.ARCH_IDS:
        cfg = C.get(aid)
        assert cfg.name == aid
        red = cfg.reduced()
        assert red.family == cfg.family
        assert red.n_layers % red.pattern_period() == 0


def test_param_counts_match_names():
    """The reference's bounds on the names' advertised sizes, with the
    port's ``count_params``, which equals the reference's leaf for leaf
    (spec trees only: nothing is drawn)."""
    expect = {
        "llama4-maverick-400b-a17b": (350e9, 450e9),
        "granite-moe-1b-a400m": (1.0e9, 1.7e9),
        "mistral-nemo-12b": (11e9, 14e9),
        "yi-9b": (8e9, 10e9),
        "llama3-8b": (7e9, 9e9),
        "internlm2-1.8b": (1.6e9, 2.2e9),
        "falcon-mamba-7b": (6e9, 9e9),
        "chameleon-34b": (30e9, 38e9),
        "zamba2-2.7b": (2.2e9, 3.4e9),
        "whisper-medium": (0.6e9, 1.0e9),
    }
    assert set(expect) == set(C.ARCH_IDS)
    for aid, (lo, hi) in expect.items():
        spec, jspec = lm.model_spec(C.get(aid)), jlm.model_spec(JC.get(aid))
        n = sp.count_params(spec)
        assert lo <= n <= hi, f"{aid}: {n / 1e9:.2f}B outside [{lo}, {hi}]"
        assert n == jsp.count_params(jspec)
        jleaves = jax.tree.leaves(jspec, is_leaf=lambda x: isinstance(
            x, jsp.ParamSpec))
        assert [sp.count_params(x) for x in sp.tree_leaves(spec)] == [
            jsp.count_params(x) for x in jleaves]


def test_all_archs_bss2_shapes_and_runnable_equal_the_references():
    ours, ref = C.all_archs(), JC.all_archs()
    assert list(ours) == list(ref)
    assert all(dataclasses.asdict(ours[a]) == dataclasses.asdict(ref[a])
               for a in ours)
    # The port's PulseCommConfig has no ``use_pallas`` switch.
    for t, j in ((C.BSS2, JC.BSS2), (C.BSS2.reduced(), JC.BSS2.reduced())):
        jd = dataclasses.asdict(j)
        del jd["comm"]["use_pallas"]
        assert dataclasses.asdict(t) == jd
    assert {k: dataclasses.asdict(v) for k, v in C.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    skipped = 0
    for aid in C.ARCH_IDS:
        for name in C.SHAPES:
            got = C.runnable(C.get(aid), C.SHAPES[name])
            assert got == jbase.runnable(JC.get(aid), jbase.SHAPES[name])
            skipped += not got[0]
    assert skipped == sum(C.get(a).long_context == "skip"
                          for a in C.ARCH_IDS)
    assert base.runnable is C.runnable


def test_the_dense_configs_take_their_unusual_shapes():
    """What the full configs run on the card: GQA groups 4 and 8, 64
    heads, n_heads x d_head unlike d_model, chameleon's layernorm."""
    got = {a: (C.get(a).n_heads // C.get(a).n_kv_heads,
               C.get(a).n_heads * C.get(a).d_head == C.get(a).d_model)
           for a in DENSE}
    assert got == {"llama3-8b": (4, True), "yi-9b": (8, True),
                   "mistral-nemo-12b": (4, False),
                   "chameleon-34b": (8, True)}
    assert C.get("chameleon-34b").norm == "layernorm"
    assert C.get("chameleon-34b").n_heads == 64
    for name in ("wide-model", "group-8"):
        j, t = _configs(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    wide, g8 = _configs("wide-model")[1], _configs("group-8")[1]
    assert wide.n_heads * wide.d_head != wide.d_model
    assert g8.n_heads // g8.n_kv_heads == 8


# ---------------------------------------------------------------------------
# The models against JAX
# ---------------------------------------------------------------------------

MODELS = DENSE + ["wide-model", "group-8"]


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    """(port cfg, port params, JAX results) of one model: the prefill
    over 20 tokens of [2, 21] and one decode step with the 21st, and
    ``loss_fn``'s loss and every gradient on [2, 16] (one ``jax.jit`` of
    ``value_and_grad``)."""
    jcfg, cfg = _configs(request.param)
    jp = jlm.init(jax.random.PRNGKey(0), jcfg)
    tk = jnp.asarray(_tokens(cfg, 2, 21))
    s = 20
    last, cache = jlm.prefill(jcfg, jp, {"tokens": tk[:, :s]})
    cache = jlm.pad_cache(jcfg, cache, s + 4)
    dec, _ = jlm.decode(jcfg, jp, tk[:, s], cache, jnp.asarray(s, jnp.int32))
    batch = {"tokens": tk[:, :16], "targets": tk[:, 1:17]}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, batch), has_aux=True))(jp)
    want = dict(tokens=np.asarray(tk), last=np.asarray(last),
                decode=np.asarray(dec), loss=float(loss),
                grads=[np.asarray(g) for g in jax.tree.leaves(grads)])
    return cfg, convert.lm_params_from_jax(jp, device=CPU), want


def test_prefill_and_decode_match_jax(model):
    cfg, params, want = model
    tk, s = T(want["tokens"]), 20
    with torch.no_grad():
        last, cache = lm.prefill(cfg, params, {"tokens": tk[:, :s]})
        cache = lm.pad_cache(cfg, cache, s + 4)
        dec, _ = lm.decode(cfg, params, tk[:, s], cache, s)
    np.testing.assert_allclose(last.numpy(), want["last"], atol=2e-4)
    np.testing.assert_allclose(dec.numpy(), want["decode"], atol=5e-4)


def test_loss_and_every_gradient_match_jax(model):
    cfg, params, want = model
    p = sp.tree_map(lambda x: x.detach().clone().requires_grad_(True),
                    params)
    tk = T(want["tokens"])
    batch = {"tokens": tk[:, :16], "targets": tk[:, 1:17]}
    loss, metrics = lm.loss_fn(cfg, p, batch, remat=True)
    assert set(metrics) == {"ce_loss", "loss"}
    grads = torch.autograd.grad(loss, sp.tree_leaves(p))
    np.testing.assert_allclose(float(loss.detach()), want["loss"], rtol=1e-5)
    assert len(grads) == len(want["grads"])
    for w, g in zip(want["grads"], grads):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


# ---------------------------------------------------------------------------
# The sliced initialiser
# ---------------------------------------------------------------------------

def _stacked_spec():
    """A stacked tree like a model's: 6 repeats of a [48, 64] matrix (the
    largest leaf), a [4, 40, 16] expert-like stack, a small-normal leaf,
    norms; and an unstacked embedding-like [150, 16]."""
    blocks = {"w": sp.ParamSpec((48, 64), (None, None)),
              "experts": sp.ParamSpec((4, 40, 16), (None, None, None),
                                      fan_in_dims=(1,)),
              "gate": sp.ParamSpec((48, 5), (None, None),
                                   init="small_normal"),
              "norm": {"scale": sp.ParamSpec((48,), (None,), init="ones"),
                       "bias": sp.ParamSpec((48,), (None,), init="zeros")}}
    return {"embed": sp.ParamSpec((150, 16), (None, None)),
            "blocks": sp.stack_specs(blocks, 6)}


def _drawn(tree) -> list:
    """The spec leaves that are drawn (not zeros or ones)."""
    return [s for s in sp.tree_leaves(tree)
            if s.init in ("normal", "small_normal")]


def _float32_allocations(fn):
    """``fn()`` and (op name, elements) of every float32 tensor that the
    ops inside it return."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for x in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
                    seen.append((func.__name__, x.numel()))
            return out

    with Record():
        result = fn()
    return result, seen


@pytest.mark.parametrize("draw_elems,block", [(4000, 48 * 64),
                                              (1000, 62 * 16)])
def test_init_holds_no_float32_beyond_one_block(monkeypatch, draw_elems,
                                                block):
    """bf16 leaves: the only float32 tensors are the draws.  With room
    for one [48, 64] slice (4000 elements) the largest draw is one slice
    of the largest leaf, never its stack of 6; with 1000, a block of rows
    (62 of the embedding's 16, 15 of the matrix's 64), below one slice.
    The draws add up to the drawn leaves: each element is drawn once."""
    tree = _stacked_spec()
    monkeypatch.setattr(sp, "DRAW_ELEMS", draw_elems)
    params, seen = _float32_allocations(lambda: sp.init_tree(
        torch.Generator().manual_seed(0), tree, torch.bfloat16, CPU))
    largest = max(math.prod(s.shape) for s in sp.tree_leaves(tree))
    assert largest == 6 * 48 * 64
    assert max(n for _, n in seen) == block <= min(draw_elems, 48 * 64)
    assert all(x.dtype == torch.bfloat16 for x in sp.tree_leaves(params))
    draws = [n for name, n in seen if "randn" in name]
    assert sum(draws) == sum(math.prod(s.shape) for s in _drawn(tree))


def test_init_is_fixed_by_the_seed_and_its_slices_differ(monkeypatch):
    tree = _stacked_spec()
    monkeypatch.setattr(sp, "DRAW_ELEMS", 1000)
    draw = lambda seed, dt=torch.float32: sp.init_tree(  # noqa: E731
        torch.Generator().manual_seed(seed), tree, dt, CPU)
    a, b, c = draw(0), draw(0), draw(1)
    specs = sp.tree_leaves(tree)
    for spec, x, y, z in zip(specs, *(sp.tree_leaves(t) for t in (a, b, c))):
        assert torch.equal(x, y)
        assert torch.equal(x, z) == (spec.init in ("zeros", "ones"))
    for name in ("w", "experts", "gate"):
        x = a["blocks"][name]
        for i in range(x.shape[0]):
            for j in range(i):
                assert not torch.equal(x[i], x[j]), (name, i, j)
    # The draws do not depend on the leaves' type: bf16 is float32 rounded.
    for x, y in zip(sp.tree_leaves(draw(0, torch.bfloat16)),
                    sp.tree_leaves(a)):
        assert torch.equal(x, y.to(torch.bfloat16))


def test_init_scales_and_exact_leaves(monkeypatch):
    """Leaves of at least 1e6 elements: N(0, 1/fan_in) and N(0, 0.02^2)
    within 2% in standard deviation, mean near 0; ``zeros`` and ``ones``
    exact."""
    tree = sp.stack_specs({
        "w": sp.ParamSpec((512, 512), (None, None)),
        "wo": sp.ParamSpec((8, 64, 512), (None, None, None),
                           fan_in_dims=(0, 1)),
        "small": sp.ParamSpec((512, 512), (None, None), init="small_normal"),
        "scale": sp.ParamSpec((512,), (None,), init="ones"),
        "bias": sp.ParamSpec((512,), (None,), init="zeros")}, 4)
    monkeypatch.setattr(sp, "DRAW_ELEMS", 100_000)
    params = sp.init_tree(torch.Generator().manual_seed(0), tree,
                          torch.float32, CPU)
    for spec, x in zip(sp.tree_leaves(tree), sp.tree_leaves(params)):
        assert tuple(x.shape) == spec.shape
        if spec.init == "zeros":
            assert not x.any()
        elif spec.init == "ones":
            assert bool((x == 1).all())
        else:
            assert x.numel() >= 1_000_000
            want = 0.02 if spec.init == "small_normal" else spec.scale()
            assert abs(float(x.std()) / want - 1) < 0.02
            assert abs(float(x.mean())) < 0.01 * want
    assert tree["wo"].scale() == 1 / math.sqrt(512)


def test_lm_init_draws_straight_into_each_leaf(monkeypatch):
    """``lm.init`` allocates each leaf once, on its device and in its
    type: a bf16 model's init makes no float32 tensor larger than one
    draw."""
    cfg = dataclasses.replace(C.get("chameleon-34b").reduced(),
                              dtype="bfloat16")
    monkeypatch.setattr(sp, "DRAW_ELEMS", 2048)
    params, seen = _float32_allocations(lambda: lm.init(
        torch.Generator().manual_seed(0), cfg, device=CPU))
    assert max(n for _, n in seen) == 2048
    assert all(x.dtype == torch.bfloat16 for x in sp.tree_leaves(params))
    assert params["blocks"]["pos0"]["attn_norm"].keys() == {"scale", "bias"}
