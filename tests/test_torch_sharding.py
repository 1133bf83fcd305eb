"""Port parity, the LM's sharding rules (``models/sharding.py``, the spec
trees, ``optim/adamw.py``'s ZeRO-1 specs, MoE's data groups), against the
JAX package on the CPU.

* Every test of ``tests/test_sharding.py`` and
  ``tests/test_optim.py::test_zero_pspecs_shard_largest_free_dim``, on the
  port's ``Rules`` over the same shape-only stand-in mesh.
* ``param_pspecs``, ``zero_pspecs``, ``zero_state_pspecs``,
  ``cache_pspecs``, ``batch_pspecs``, ``input_specs`` and ``param_shapes``
  equal the reference's leaf for leaf (``tuple(PartitionSpec)``; shapes
  and types), for every arch the port has and every cell of ``SHAPES``,
  on 16 x 16, 2 x 16 x 16 and kv-factored stand-in meshes.
* MoE's local dispatch with stand-in rules of data 2 and 4 against JAX's
  with the same rules (its ``with_sharding_constraint`` replaced by the
  identity: it needs a real mesh of that size and changes no value):
  routing bitwise, the output within 1e-5 (``tests/test_torch_moe.py``'s
  bound: float32 products and softmax summed in another order), the
  metrics within 1e-6 relative.
* In gloo processes at worlds 2 and 4 (``tests/torch_dist.py``): the
  DTensor placements from ``Rules.sharding``, each rank's shard against
  the slice the reference's spec implies (bitwise), and ``shard``
  redistributing a DTensor.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.configs as JC  # noqa: E402
import repro.models.moe as jmoe  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import sharding as jshd  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models import sharding as shd  # noqa: E402
from repro_torch.models import spec as sp  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

import torch_dist  # noqa: E402


class FakeMesh:
    """Shape-only stand-in, as ``tests/test_sharding.py``'s: the
    divisibility rules without 256 ranks."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _rules(data=16, model=16, pod=None, rules=shd.Rules):
    shape = {"data": data, "model": model}
    batch = ("data",)
    if pod:
        shape = {"pod": pod, **shape}
        batch = ("pod", "data")
    return rules(mesh=FakeMesh(shape), batch_axes=batch)


def _kv_rules(rules=shd.Rules):
    return rules(mesh=FakeMesh({"data": 16, "kv": 8, "mp": 2}),
                 batch_axes=("data",), tensor_axis=("kv", "mp"),
                 kv_axis="kv")


# Each stand-in mesh as (port rules, reference rules).
MESHES = {
    "16x16": lambda: (_rules(), _rules(rules=jshd.Rules)),
    "2x16x16": lambda: (_rules(pod=2), _rules(pod=2, rules=jshd.Rules)),
    "kv": lambda: (_kv_rules(), _kv_rules(rules=jshd.Rules)),
}


# ---------------------------------------------------------------------------
# tests/test_sharding.py and test_optim.py's ZeRO test, on the port
# ---------------------------------------------------------------------------

def test_divisible_dims_shard():
    r = _rules()
    assert r.pspec(("batch", None, "heads"), (256, 4096, 32)) == \
        shd.PartitionSpec("data", None, "model")


def test_non_divisible_tensor_dim_replicates():
    assert _rules().pspec(("batch", "kv_heads"), (256, 8)) == \
        shd.PartitionSpec("data", None)


def test_batch_fallback_pod_to_data():
    r = _rules(pod=2)
    assert r.pspec(("batch",), (16,)) == shd.PartitionSpec("data")
    assert r.pspec(("batch",), (32,)) == shd.PartitionSpec(("pod", "data"))
    assert r.pspec(("batch",), (1,)) == shd.PartitionSpec(None)


def test_vocab_divisibility():
    r = _rules()
    assert r.pspec((None, "vocab"), (1024, 49155)) == \
        shd.PartitionSpec(None, None)
    assert r.pspec((None, "vocab"), (1024, 202048)) == \
        shd.PartitionSpec(None, "model")


def test_from_mesh_detects_pod_axis():
    assert shd.from_mesh(FakeMesh({"data": 1, "model": 1})).batch_axes == \
        ("data",)
    assert shd.from_mesh(FakeMesh({"pod": 2, "data": 1, "model": 1})
                         ).batch_axes == ("pod", "data")
    kv = shd.from_mesh(FakeMesh({"data": 16, "kv": 8, "mp": 2}))
    assert (kv.tensor_axis, kv.kv_axis) == (("kv", "mp"), "kv")


def test_kv_factored_rules():
    r = _kv_rules()
    assert r.pspec(("batch", "kv_heads", None, None),
                   (128, 8, 32768, 128)) == \
        shd.PartitionSpec("data", "kv", None, None)
    assert r.pspec((None, "heads", None), (4096, 32, 128)) == \
        shd.PartitionSpec(None, ("kv", "mp"), None)


def test_shard_noop_without_rules():
    x = torch.zeros((4, 4))
    assert shd.shard(x, None, "batch", None) is x
    # With rules, a plain tensor (the local view) comes back as it is,
    # after the rank check.
    assert shd.shard(x, _rules(), "batch", None) is x
    with pytest.raises(ValueError, match="rank mismatch"):
        shd.shard(x, _rules(), "batch")


def test_param_pspecs_cover_every_leaf():
    r = _rules()
    for arch in C.ARCH_IDS:
        cfg = C.get(arch)
        shapes = sp.tree_leaves(lm.param_shapes(cfg))
        pspecs = sp.tree_leaves(lm.param_pspecs(cfg, r))
        assert len(shapes) == len(pspecs)
        for t, ps in zip(shapes, pspecs):
            assert t.device.type == "meta"
            assert len(ps) <= t.ndim
            for dim, axis in zip(t.shape, tuple(ps)):
                if axis is None:
                    continue
                axes = (axis,) if isinstance(axis, str) else axis
                prod = int(np.prod([{"data": 16, "model": 16,
                                     "pod": 2}[a] for a in axes]))
                assert dim % prod == 0, (arch, t.shape, ps)


def test_zero_pspecs_shard_largest_free_dim():
    rules = _rules(data=1, model=1)
    spec = {"w": sp.ParamSpec((8, 4), (None, "ff"))}
    assert adamw.zero_pspecs(spec, rules)["w"] == \
        shd.PartitionSpec("data", "model")


def test_placements_follow_the_spec_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    r = _rules(pod=2)
    assert r.sharding(("batch", None, "heads"), (64, 8, 32)) == \
        (Shard(0), Shard(0), Shard(2))
    assert r.sharding(("batch", "kv_heads"), (16, 8)) == \
        (Replicate(), Shard(0), Replicate())
    assert _kv_rules().sharding((None, "heads", None), (8, 32, 4)) == \
        (Replicate(), Shard(1), Shard(1))
    mesh = FakeMesh({"data": 2, "model": 2})
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements(mesh, shd.PartitionSpec(("model", "data")))
    with pytest.raises(ValueError, match="not in the mesh"):
        shd.placements(mesh, shd.PartitionSpec("pod"))
    with pytest.raises(ValueError, match="shards two"):
        shd.placements(mesh, shd.PartitionSpec("data", "data"))


# ---------------------------------------------------------------------------
# The spec trees against the reference's, leaf for leaf
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    """The port's tree in the reference's leaf order: dicts by sorted key,
    NamedTuples by field, a None dropped (an empty subtree in JAX), a
    PartitionSpec or a tensor a leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _jax_leaves(tree) -> list:
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))


def _same_specs(got, want):
    got, want = _leaves(got), _jax_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, shd.PartitionSpec)
        assert tuple(g) == tuple(w), (g, w)


def _same_shapes(got, want):
    got, want = _leaves(got), _jax_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == np.dtype(w.dtype).name


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_spec_trees_equal_the_references(arch, mesh):
    """``param_pspecs``, ``adamw.param_pspecs``, ``zero_pspecs``,
    ``zero_state_pspecs`` and ``param_shapes`` at full size, and for each
    cell of ``SHAPES`` ``input_specs``, ``batch_pspecs`` and, where the
    cell decodes, ``cache_pspecs`` of its cache."""
    rules, jrules = MESHES[mesh]()
    cfg, jcfg = C.get(arch), JC.get(arch)
    spec, jspec = lm.model_spec(cfg), jlm.model_spec(jcfg)
    _same_specs(lm.param_pspecs(cfg, rules), jlm.param_pspecs(jcfg, jrules))
    _same_specs(adamw.param_pspecs(spec, rules),
                jadamw.param_pspecs(jspec, jrules))
    _same_specs(adamw.zero_pspecs(spec, rules),
                jadamw.zero_pspecs(jspec, jrules))
    _same_specs(adamw.zero_state_pspecs(spec, rules),
                jadamw.zero_state_pspecs(jspec, jrules))
    _same_shapes(lm.param_shapes(cfg), jlm.param_shapes(jcfg))
    for name, shape in base.SHAPES.items():
        jshape = jbase.SHAPES[name]
        assert lm.cache_len_for(cfg, shape) == jlm.cache_len_for(jcfg,
                                                                 jshape)
        specs, jspecs = (lm.input_specs(cfg, shape),
                         jlm.input_specs(jcfg, jshape))
        _same_shapes(specs, jspecs)
        _same_specs(lm.batch_pspecs(cfg, shape, rules),
                    jlm.batch_pspecs(jcfg, jshape, jrules))
        if "cache" in specs and not cfg.is_encdec:
            _same_specs(tfm.cache_pspecs(specs["cache"], rules),
                        jtfm.cache_pspecs(jspecs["cache"], jrules))


def test_cache_and_state_specs_are_meta():
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm

    cfg = C.get("zamba2-2.7b")
    kv = attn.cache_spec(cfg, 2, 64, torch.bfloat16)
    st = ssm.ssm_state_spec(cfg, 2, torch.bfloat16)
    assert kv.k.device.type == st.h.device.type == "meta"
    assert tuple(kv.k.shape) == (2, cfg.n_kv_heads, 64, cfg.d_head)
    assert (st.h.dtype, tuple(st.conv.shape)) == (
        torch.float32, (2, cfg.ssm_conv - 1, cfg.d_inner))
    assert attn.cache_axes().k == ("batch", "kv_heads", None, None)
    assert ssm.ssm_state_axes() == ssm.SSMState(
        h=("batch", "d_inner", None), conv=("batch", None, "d_inner"))
    cache = lm.make_cache(cfg, 2, 64, device="meta")
    assert all(x.device.type == "meta" for x in _leaves(cache))


def test_sharding_tree_gives_placements_per_leaf():
    from torch.distributed.tensor import Replicate, Shard

    cfg = C.get("internlm2-1.8b")
    tree = sp.sharding_tree(lm.model_spec(cfg), _rules())
    assert tree["blocks"]["pos0"]["mlp"]["w_up"] == \
        (Replicate(), Shard(2))
    # The vocabulary, 92544, shards 16 ways; d_model stays whole.
    assert tree["embed"]["tokens"] == (Replicate(), Shard(0))
    assert tree["final_norm"]["scale"] == (Replicate(), Replicate())


# ---------------------------------------------------------------------------
# MoE's local dispatch over data groups
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_layer():
    """(jax cfg, port cfg, jax layer params, port layer params, x) of
    reduced granite's first MoE layer, x [4, 16, 64] from numpy."""
    name = "granite-moe-1b-a400m"
    jcfg, cfg = JC.get(name).reduced(), C.get(name).reduced()
    jp = jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    mp = jax.tree.map(lambda p: p[0], jp["blocks"]["pos0"]["moe"])
    x = np.random.default_rng(11).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, mp, convert.lm_params_from_jax(mp, device="cpu"), x


def _jax_local_routing(cfg, mp, x, g):
    """The reference's local routing (``moe.py:78-95``) over g groups:
    expert choices [G, Tl, k], slots and counts per group, capacity."""
    b, s, d = x.shape
    t = b * s
    xg = jnp.asarray(x).reshape(g, t // g, d)
    logits = jnp.einsum("gtd,de->gte", xg, mp["router"].astype(jnp.float32))
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    flat = idx.reshape(g, -1)
    slot, counts = jax.vmap(lambda ee: jmoe.bk.compute_slots_sorted(
        ee, jnp.ones_like(ee, bool), cfg.n_experts))(flat)
    cap = max(8, -(-jmoe.capacity(cfg, t) // (8 * g)) * 8)
    return idx, slot, counts, cap


@pytest.mark.parametrize("cf", [8.0, 0.25])
@pytest.mark.parametrize("groups", [2, 4])
def test_moe_local_dispatch_takes_its_groups_from_the_rules(
        moe_layer, groups, cf, monkeypatch):
    jcfg, cfg, mp, p, x = moe_layer
    monkeypatch.setattr(jmoe, "shard", lambda x, r, *a: x)
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf,
                               moe_dispatch="local")
    cfg = dataclasses.replace(cfg, capacity_factor=cf, moe_dispatch="local")
    jrules = _rules(data=groups, model=1, rules=jshd.Rules)
    rules = _rules(data=groups, model=1)
    assert moe._data_groups(rules, 4) == jmoe._data_groups(jrules, 4) == \
        groups
    assert moe._data_groups(None, 4) == 1
    wy, wm = jax.jit(jmoe.moe_apply, static_argnums=(0, 3))(
        jcfg, mp, jnp.asarray(x), jrules)
    routing = {}
    y, m = moe.moe_apply(cfg, p, torch.as_tensor(x), rules=rules,
                         routing=routing)
    idx, slot, counts, cap = _jax_local_routing(jcfg, mp, x, groups)
    assert routing["capacity"] == cap
    np.testing.assert_array_equal(routing["expert_idx"].numpy(),
                                  np.asarray(idx))
    np.testing.assert_array_equal(routing["slot"].reshape(groups, -1).numpy(),
                                  np.asarray(slot))
    np.testing.assert_array_equal(routing["keep"].reshape(groups, -1).numpy(),
                                  np.asarray(slot) < cap)
    np.testing.assert_array_equal(routing["counts"].numpy(),
                                  np.asarray(counts))
    assert float(m["drop_fraction"]) == float(wm["drop_fraction"])
    assert (float(m["drop_fraction"]) > 0) == (cf == 0.25)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-5)
    for key in ("aux_loss", "bucket_utilization"):
        np.testing.assert_allclose(float(m[key]), float(wm[key]), rtol=1e-6)


# ---------------------------------------------------------------------------
# DTensor placements in gloo processes
# ---------------------------------------------------------------------------

# (mesh name, logical axes, shape) at each world; the meshes are
# torch_dist.SHARD_MESHES'.
PLACEMENT_CASES = {
    2: {"batch_heads": ("host", ("batch", None, "heads"), (4, 3, 2)),
        "ff": ("model", (None, "ff"), (3, 8)),
        "vocab_odd": ("model", (None, "vocab"), (2, 5))},
    4: {"batch_heads": ("host", ("batch", None, "heads"), (4, 3, 2)),
        "pod_batch": ("pod", ("batch", None), (8, 3)),
        "pod_fallback": ("pod", ("batch", None), (6, 3)),
        "kv_heads": ("kv", ("batch", "kv_heads", None, None), (2, 4, 3, 2)),
        "kv_tier": ("kv", (None, "heads", None), (3, 8, 2))},
}


def _jax_slice(spec, shape, mesh_shape, names, rank):
    """The block of a tensor of ``shape`` that ``rank`` of a mesh holds
    under the reference's ``spec``: along each dimension, the mixed-radix
    index of the rank's coordinates on the dimension's axes (the first
    axis outer)."""
    coords = dict(zip(names, np.unravel_index(rank, mesh_shape)))
    sizes = dict(zip(names, mesh_shape))
    index = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        i, n = 0, 1
        for a in axes:
            i, n = i * sizes[a] + int(coords[a]), n * sizes[a]
        index.append(slice(i * dim // n, (i + 1) * dim // n))
    return tuple(index)


@pytest.fixture(scope="module", params=[2, 4])
def placed(request, tmp_path_factory):
    world = request.param
    rng = np.random.default_rng(world)
    cases = {k: (m, axes, torch.as_tensor(
        rng.standard_normal(shape).astype(np.float32)))
        for k, (m, axes, shape) in PLACEMENT_CASES[world].items()}
    ranks = torch_dist.spawn(torch_dist.sharding_worker, world,
                             tmp_path_factory.mktemp(f"shard{world}"), cases)
    return world, cases, ranks


def test_placements_give_each_rank_the_references_slice(placed):
    world, cases, ranks = placed
    for key, (mesh_name, axes, x) in cases.items():
        mesh_shape, names = torch_dist.SHARD_MESHES[world][mesh_name]
        jrules = jshd.from_mesh(FakeMesh(dict(zip(names, mesh_shape))))
        spec = jrules.pspec(axes, tuple(x.shape))
        want_pl = [repr(p) for p in shd.placements(
            FakeMesh(dict(zip(names, mesh_shape))),
            shd.PartitionSpec(*spec))]
        for rank, out in enumerate(ranks):
            got = out[key]
            assert got["placements"] == want_pl, (key, rank)
            want = x[_jax_slice(spec, x.shape, mesh_shape, names, rank)]
            assert torch.equal(got["local"], want), (key, rank, spec)


def test_shard_redistributes_a_dtensor(placed):
    world, cases, ranks = placed
    for key, (_, _, x) in cases.items():
        for out in ranks:
            got = out[key]
            assert got["shard_placements"] == got["placements"]
            assert torch.equal(got["shard_local"], got["local"])
            assert torch.equal(got["shard_full"], x)
            assert got["plain_is_x"]
            assert got["rank_error"].startswith("ValueError: rank mismatch")


# ---------------------------------------------------------------------------
# The models under rules: every shard call's rank, no value changed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_models_under_rules_give_the_same_bits(arch):
    """The loss, its gradients, a prefill and a decode step of each
    reduced arch with stand-in rules (data 2, model 2: every ``shard``
    call checks its rank, and plain tensors pass unchanged) equal the
    run without rules bitwise; the MoE's local dispatch is left out (its
    data groups change the routing by design)."""
    from repro_torch.data import pipeline as dp

    cfg = C.get(arch).reduced()
    rules = _rules(data=2, model=2)
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8)),
             "targets": rng.integers(0, cfg.vocab_size, (2, 8))}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (2, 12, cfg.d_model)).astype(np.float32)
    batch = dp.to_device(batch, "cpu")
    out = []
    for r in (None, rules):
        p = sp.tree_map(lambda x: x.clone().requires_grad_(True), params)
        loss, _ = lm.loss_fn(cfg, p, batch, rules=r, remat=False)
        grads = torch.autograd.grad(loss, sp.tree_leaves(p))
        with torch.no_grad():
            last, cache = lm.prefill(cfg, params, batch, rules=r)
            cache = lm.pad_cache(cfg, cache, 10)
            tok = last.argmax(-1).to(torch.int32)
            step, _ = lm.decode(cfg, params, tok, cache, 8, rules=r)
        out.append((loss, *grads, last, step))
    for a, b in zip(*out):
        assert torch.equal(a, b)
