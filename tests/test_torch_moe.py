"""Port parity, the MoE slice: ``core.buckets.compute_slots_sorted``,
``unpack`` and ``bucket_dest_chip``, the MoE layer (``models/moe.py``,
global and local dispatch), the reduced granite-moe-1b-a400m (32 experts
top-8 cut to 4 experts top-2, d_model 64) and llama4-maverick-400b-a17b
(an MoE block every second layer, top-1) through ``forward``,
``prefill``/``decode`` and ``loss_fn``, the remat policies and
``repro_torch.moe_routing``, against the JAX package on the CPU, from the
same numpy inputs and the same weights (``convert.lm_params_from_jax``).

Tolerances, each with its reason:
* integers bitwise: slots, counts, expert choices, ``keep``, and
  ``drop_fraction`` (a ratio of two integers);
* the MoE layer's output within 1e-5 (float32 products and softmax summed
  in another order; the combine adds a token's k lanes in the
  reference's lane order); ``aux_loss`` and ``bucket_utilization``
  within 1e-6 relative (float32 means over E and T);
* the model: the dense model's bounds of ``tests/test_torch_lm.py`` and
  ``tests/test_torch_train.py``: logits of a forward and a prefill within
  2e-4, a decode step within 5e-4, the loss within 1e-5 relative and each
  gradient within 1e-5 of its leaf's largest |g|; the remat policies
  bitwise.

Routing is discrete: a router logit a rounding apart can flip a top-k
choice at a near-tie.  Every comparison here checks the integer routing
first, and the seeded inputs have no such near-tie (the smallest gap
between the k-th and (k+1)-th probability is printed by the card's
checks, not here).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.core import buckets as jbk  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import convert, moe_routing  # noqa: E402
from repro_torch.core import buckets as bk  # noqa: E402
from repro_torch.kernels import common as kc  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models import spec as sp  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

GRANITE, LLAMA4 = "granite-moe-1b-a400m", "llama4-maverick-400b-a17b"
MOE_ARCHS = [GRANITE, LLAMA4]
CPU = "cpu"


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


# ---------------------------------------------------------------------------
# compute_slots_sorted, unpack, bucket_dest_chip
# ---------------------------------------------------------------------------

def _edge_case(case):
    """The reference's edge cases (``tests/test_buckets.py``)."""
    if case == "all_invalid":
        return [0, 1, 2, 1], [False] * 4, 3
    if case == "overflow":
        return [0] * 64, [True] * 64, 2
    if case == "one_bucket":
        return [5] * 16, [True] * 16, 6
    return ([2, 0, 2, 1, 2, 0], [True, False, True, False, True, True], 3)


def _slots_equal(bid, valid, nb):
    bid, valid = np.asarray(bid, np.int32), np.asarray(valid, bool)
    ws, wc = jbk.compute_slots_sorted(jnp.asarray(bid), jnp.asarray(valid),
                                      nb)
    gs, gc = bk.compute_slots_sorted(T(bid), T(valid), nb)
    assert gs.dtype == gc.dtype == torch.int32
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("case", ["all_invalid", "overflow", "one_bucket",
                                  "empty_mix"])
def test_compute_slots_sorted_edge_cases_bitwise(case):
    """Every lane's slot (invalid lanes too) and the counts."""
    _slots_equal(*_edge_case(case))


@pytest.mark.parametrize("seed,nb", [(0, 3), (1, 17), (2, 40)])
def test_compute_slots_sorted_seeded_stream_bitwise(seed, nb):
    """20 seeded streams of 257 lanes a row (a leading axis, against
    ``jax.vmap``), ids in and out of range: jnp's scatter rule for the
    counts, its gather rule for the prefix."""
    rng = np.random.default_rng(seed)
    bid = rng.integers(-nb - 3, 2 * nb + 3, (20, 257)).astype(np.int32)
    valid = rng.random((20, 257)) < 0.8
    ws, wc = jax.vmap(lambda b, v: jbk.compute_slots_sorted(b, v, nb))(
        jnp.asarray(bid), jnp.asarray(valid))
    gs, gc = bk.compute_slots_sorted(T(bid), T(valid), nb)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    _slots_equal(bid[0], valid[0], nb)


def test_compute_slots_sorted_agrees_with_compute_slots():
    """The two slot rules agree on valid lanes and on the counts (the
    reference's property), the event path's and the token path's."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        e, nb = int(rng.integers(1, 200)), int(rng.integers(1, 12))
        bid, valid = T(rng.integers(0, nb, e)), T(rng.random(e) < 0.7)
        s1, c1 = bk.compute_slots(bid, valid, nb)
        s2, c2 = bk.compute_slots_sorted(bid, valid, nb)
        assert torch.equal(c1, c2) and torch.equal(s1[valid], s2[valid])


def test_unpack_and_bucket_dest_chip_match_jax():
    rng = np.random.default_rng(4)
    e, nb, cap = 50, 4, 6
    bid, addr = rng.integers(0, nb, e), rng.integers(0, 1000, e)
    dead, valid = rng.integers(0, 300, e), rng.random(e) < 0.8
    want = jbk.unpack(jbk.pack(*(jnp.asarray(x) for x in (
        bid.astype(np.int32), addr.astype(np.int32),
        dead.astype(np.int32), valid)), n_buckets=nb, capacity=cap))
    got = bk.unpack(bk.pack(T(bid, torch.int32), T(addr, torch.int32),
                            T(dead, torch.int32), T(valid), n_buckets=nb,
                            capacity=cap))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    table = bk.bucket_dest_chip(5, 3)
    assert table.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(),
                                  np.asarray(jbk.bucket_dest_chip(5, 3)))


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer():
    """(jax cfg, port cfg, jax layer params, port layer params, x) of
    reduced granite's first MoE layer, as ``tests/test_moe_local.py``
    takes it, and x [2, 16, 64] from numpy."""
    jcfg, cfg = JC.get(GRANITE).reduced(), C.get(GRANITE).reduced()
    jp = jlm.init(jax.random.PRNGKey(0), jcfg)
    mp = jax.tree.map(lambda p: p[0], jp["blocks"]["pos0"]["moe"])
    x = np.random.default_rng(5).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, mp, convert.lm_params_from_jax(mp, device=CPU), x


def _jax_routing(cfg, mp, x):
    """The reference's routing steps (``moe.py:145-163``) on x: expert
    choices [T, k], slots [T k], counts [E] and capacity."""
    t = x.shape[0] * x.shape[1]
    logits = jnp.einsum("td,de->te", jnp.asarray(x).reshape(t, -1),
                        mp["router"].astype(jnp.float32))
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    flat = idx.reshape(-1)
    slot, counts = jbk.compute_slots_sorted(flat, jnp.ones_like(flat, bool),
                                            cfg.n_experts)
    return idx, slot, counts, jmoe.capacity(cfg, t)


@pytest.mark.parametrize("dispatch", ["global", "local"])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
def test_moe_apply_matches_jax(layer, dispatch, cf):
    """Routing bitwise (expert choices, slots, keep, counts,
    drop_fraction), then the output within 1e-5 and the other metrics
    within 1e-6 relative, at ample, the config's own and a squeezed
    capacity factor."""
    jcfg, cfg, mp, p, x = layer
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf,
                               moe_dispatch=dispatch)
    cfg = dataclasses.replace(cfg, capacity_factor=cf, moe_dispatch=dispatch)
    wy, wm = jmoe.moe_apply(jcfg, mp, jnp.asarray(x), None)
    routing = {}
    y, m = moe.moe_apply(cfg, p, T(x), routing=routing)
    idx, slot, counts, cap = _jax_routing(jcfg, mp, x)
    assert routing["capacity"] == cap
    np.testing.assert_array_equal(routing["expert_idx"][0].numpy(),
                                  np.asarray(idx))
    np.testing.assert_array_equal(routing["slot"].reshape(-1).numpy(),
                                  np.asarray(slot))
    np.testing.assert_array_equal(routing["keep"].reshape(-1).numpy(),
                                  np.asarray(slot) < cap)
    np.testing.assert_array_equal(routing["counts"][0].numpy(),
                                  np.asarray(counts))
    assert float(m["drop_fraction"]) == float(wm["drop_fraction"])
    assert (float(m["drop_fraction"]) > 0) == (cf == 0.25)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=1e-5)
    for key in ("aux_loss", "bucket_utilization"):
        np.testing.assert_allclose(float(m[key]), float(wm[key]), rtol=1e-6)


def test_local_equals_global_at_ample_capacity(layer):
    """As ``tests/test_moe_local.py``: at capacity factor 8 the local
    dispatch (one group) equals the global one; at 0.25 it drops."""
    _, cfg, _, p, x = layer
    cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    y_g, m_g = moe.moe_apply(cfg, p, T(x))
    local = dataclasses.replace(cfg, moe_dispatch="local")
    y_l, m_l = moe.moe_apply(local, p, T(x))
    np.testing.assert_allclose(y_g.numpy(), y_l.numpy(), atol=1e-5)
    assert float(m_g["drop_fraction"]) == float(m_l["drop_fraction"]) == 0.0
    np.testing.assert_allclose(float(m_g["aux_loss"]),
                               float(m_l["aux_loss"]), rtol=1e-5)
    _, m_tight = moe.moe_apply(dataclasses.replace(local,
                                                   capacity_factor=0.25),
                               p, T(x))
    assert float(m_tight["drop_fraction"]) > 0.0


def test_top_k_ties_go_to_the_lower_expert(layer):
    """``jax.lax.top_k`` returns the k largest in descending order, equal
    values to the lower index first; the port's stable descending sort
    does the same.  A zero router gives every expert the same
    probability; a router with two equal columns ties two experts."""
    jcfg, cfg, mp, _, x = layer
    r = np.zeros_like(np.asarray(mp["router"]))
    tied = r.copy()
    tied[:, :2] = np.random.default_rng(6).standard_normal(
        (r.shape[0], 1)).astype(np.float32)
    for router in (r, tied):
        idx = _jax_routing(jcfg, dict(mp, router=jnp.asarray(router)), x)[0]
        got = moe.route(T(x).reshape(-1, cfg.d_model), T(router),
                        cfg.top_k)[2]
        np.testing.assert_array_equal(got.numpy(), np.asarray(idx))
    # Uniform: experts 0 and 1 on every token; tied: the pair (0, 1) or
    # (2, 3), the lower first, on each token.
    top = got.numpy()
    assert set(map(tuple, top)) <= {(0, 1), (2, 3)}
    assert len(set(map(tuple, top))) == 2


def test_moe_layer_accumulates_no_float_scatter(layer):
    """No atomics on the layer's path: its forward and backward run no
    ``index_add``, no floating ``scatter_add`` and no accumulating
    ``index_put`` (the integer bucket counts may use ``scatter_add``, whose
    sums do not depend on order)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, cfg, _, p, x = layer
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.__name__
            first = args[0] if args else None
            floating = isinstance(first, torch.Tensor) and \
                first.is_floating_point()
            accumulate = ("index_put" in name
                          and (kwargs.get("accumulate") or (
                              len(args) > 3 and args[3])))
            if ("index_add" in name or accumulate
                    or ("scatter_add" in name and floating)
                    or ("scatter_reduce" in name and floating)):
                seen.append(name)
            return out

    w = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xt = T(x).requires_grad_(True)
    with Record():
        y, m = moe.moe_apply(dataclasses.replace(cfg, capacity_factor=0.5),
                             w, xt)
        (y.square().sum() + m["aux_loss"]).backward()
    assert seen == [], seen
    assert all(v.grad is not None for v in w.values())


# ---------------------------------------------------------------------------
# The reduced models
# ---------------------------------------------------------------------------

def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def model(request):
    """(arch, port cfg, port params, JAX results) of a reduced MoE arch:
    the forward's logits and metrics on [2, 24] tokens, the prefill over
    20 tokens and one decode step, and ``loss_fn``'s loss, metrics and
    gradients (one ``jax.jit`` of ``value_and_grad``)."""
    arch = request.param
    jcfg, cfg = JC.get(arch).reduced(), C.get(arch).reduced()
    jp = jlm.init(jax.random.PRNGKey(0), jcfg)
    tk = jnp.asarray(_tokens(cfg, 2, 24))
    fwd = jtfm.forward(jcfg, jp, tk, None)
    s = 20
    last, cache = jlm.prefill(jcfg, jp, {"tokens": tk[:, :s]})
    cache = jlm.pad_cache(jcfg, cache, s + 4)
    dec, _ = jlm.decode(jcfg, jp, tk[:, s], cache, jnp.asarray(s, jnp.int32))
    batch = {"tokens": tk[:, :16], "targets": tk[:, 1:17]}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, batch), has_aux=True))(jp)
    want = dict(tokens=np.asarray(tk), logits=np.asarray(fwd.logits),
                metrics={k: float(v) for k, v in fwd.metrics.items()},
                last=np.asarray(last), decode=np.asarray(dec), loss=loss,
                loss_metrics={k: float(v) for k, v in metrics.items()},
                grads=[np.asarray(g) for g in jax.tree.leaves(grads)])
    return arch, cfg, convert.lm_params_from_jax(jp, device=CPU), want


def test_forward_logits_and_metrics_match_jax(model):
    """Logits within 2e-4; ``drop_fraction`` exact, the other metrics
    within 1e-6 relative: each summed over a repeat's pattern positions,
    then averaged over the repeats (llama4: one MoE position of two)."""
    _, cfg, params, want = model
    with torch.no_grad():
        out = tfm.forward(cfg, params, T(want["tokens"]))
    np.testing.assert_allclose(out.logits.numpy(), want["logits"], atol=2e-4)
    assert set(out.metrics) == set(want["metrics"]) == {
        "aux_loss", "drop_fraction", "bucket_utilization"}
    assert float(out.metrics["drop_fraction"]) == \
        want["metrics"]["drop_fraction"]
    for key in ("aux_loss", "bucket_utilization"):
        np.testing.assert_allclose(float(out.metrics[key]),
                                   want["metrics"][key], rtol=1e-6)


def test_prefill_and_decode_match_jax(model):
    """Prefill over 20 tokens within 2e-4, one decode step (the MoE layer
    routes its 2 tokens at their own capacity) within 5e-4."""
    _, cfg, params, want = model
    tk, s = T(want["tokens"]), 20
    with torch.no_grad():
        last, cache = lm.prefill(cfg, params, {"tokens": tk[:, :s]})
        cache = lm.pad_cache(cfg, cache, s + 4)
        dec, _ = lm.decode(cfg, params, tk[:, s], cache, s)
    np.testing.assert_allclose(last.numpy(), want["last"], atol=2e-4)
    np.testing.assert_allclose(dec.numpy(), want["decode"], atol=5e-4)


def _port_grads(cfg, params, tokens, remat):
    p = sp.tree_map(lambda x: x.detach().clone().requires_grad_(True),
                    params)
    batch = {"tokens": tokens[:, :16], "targets": tokens[:, 1:17]}
    loss, metrics = lm.loss_fn(cfg, p, batch, remat=remat)
    return loss.detach(), metrics, torch.autograd.grad(loss,
                                                       sp.tree_leaves(p))


def test_loss_and_every_gradient_match_jax(model):
    """``loss_fn`` adds ``MOE_AUX_WEIGHT`` x aux_loss: the loss within
    1e-5 relative, the metrics as in the forward, every gradient within
    1e-5 of its leaf's largest |g|."""
    _, cfg, params, want = model
    loss, metrics, grads = _port_grads(cfg, params, T(want["tokens"]),
                                       remat=True)
    assert set(metrics) == set(want["loss_metrics"])
    np.testing.assert_allclose(float(loss), float(want["loss"]), rtol=1e-5)
    for key in ("ce_loss", "aux_loss"):
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   want["loss_metrics"][key], rtol=1e-5)
    ce, aux = (float(metrics[k].detach()) for k in ("ce_loss", "aux_loss"))
    np.testing.assert_allclose(float(loss), ce + lm.MOE_AUX_WEIGHT * aux,
                               rtol=1e-6)
    assert len(grads) == len(want["grads"])
    for w, g in zip(want["grads"], grads):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
def test_remat_policies_give_bitwise_equal_gradients(model, policy):
    """Under ``remat`` the expert products (``bmm``, batched over the
    experts) are recomputed and the router's ``mm`` kept under "dots",
    as ``dots_with_no_batch_dims_saveable`` keeps them; every policy gives
    the bits of ``remat=False``."""
    _, cfg, params, want = model
    tk = T(want["tokens"])
    ref = _port_grads(cfg, params, tk, remat=False)
    got = _port_grads(dataclasses.replace(cfg, remat_policy=policy), params,
                      tk, remat=True)
    assert torch.equal(got[0], ref[0])
    for a, b in zip(got[2], ref[2]):
        assert torch.equal(a, b)


def test_serve_consistency_at_ample_capacity(model):
    """prefill + decode equals the full forward at the next position, at
    capacity factor 8 as the reference's own test runs an MoE model
    (capacity depends on the tokens of a call: a prefill's, a forward's
    and a decode step's differ, so drops would differ)."""
    _, cfg, params, _ = model
    cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    b, s = 2, 16
    tk = T(_tokens(cfg, b, s + 1, seed=3))
    with torch.no_grad():
        full = tfm.forward(cfg, params, tk)
        last, cache = lm.prefill(cfg, params, {"tokens": tk[:, :s]})
        cache = lm.pad_cache(cfg, cache, s + 4)
        dec, _ = lm.decode(cfg, params, tk[:, s], cache, s)
    assert float(full.metrics["drop_fraction"]) == 0.0
    np.testing.assert_allclose(last.numpy(), full.logits[:, s - 1].numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(dec.numpy(), full.logits[:, s].numpy(),
                               atol=5e-4)


# ---------------------------------------------------------------------------
# The entry points
# ---------------------------------------------------------------------------

def test_moe_routing_rows_match_jax(layer):
    """``moe_routing.sweep`` against ``repro.models.moe.moe_apply`` at
    each capacity factor of ``examples/moe_routing.py``, on the same
    layer and x: capacity and drop_fraction exact, aux_loss and
    bucket_utilization within 1e-6 relative; the slot contract holds."""
    jcfg, cfg, mp, p, x = layer
    rows = moe_routing.sweep(cfg, p, T(x))
    assert [r["capacity_factor"] for r in rows] == list(
        moe_routing.FACTORS)
    for r in rows:
        c = dataclasses.replace(jcfg, capacity_factor=r["capacity_factor"])
        _, wm = jmoe.moe_apply(c, mp, jnp.asarray(x), None)
        assert r["capacity"] == jmoe.capacity(c, 32)
        assert r["drop_fraction"] == float(wm["drop_fraction"])
        for key in ("aux_loss", "bucket_utilization"):
            np.testing.assert_allclose(r[key], float(wm[key]), rtol=1e-6)
    assert rows[-1]["drop_fraction"] > 0.0
    dest = T(np.random.default_rng(7).integers(0, 4, 64), torch.int32)
    assert moe_routing.same_slots(dest, 4)


def test_moe_routing_cli_on_the_cpu(capsys):
    rows = moe_routing.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(rows) == len(moe_routing.FACTORS)
    assert "4 experts, top-2" in out and "VERIFIED" in out


def test_train_step_reports_the_moe_metrics(capsys, tmp_path):
    """A training step's metrics carry the MoE's, finite; the CLI prints
    them on its step lines."""
    cfg = C.get(GRANITE).reduced()
    state = train.build_train_state(torch.Generator().manual_seed(0), cfg,
                                    device=CPU)
    step = train.make_step(cfg, peak_lr=1e-3, total_steps=4, remat=False)
    tk = torch.randint(0, cfg.vocab_size, (2, 17),
                       generator=torch.Generator().manual_seed(1))
    _, m = step(state, {"tokens": tk[:, :16], "targets": tk[:, 1:]})
    for key in ("aux_loss", "drop_fraction", "bucket_utilization"):
        assert bool(torch.isfinite(m[key]))
    train.main(["--device", "cpu", "--arch", GRANITE, "--reduced", "--steps",
                "2", "--batch", "2", "--seq", "16", "--log-every", "1",
                "--ckpt-dir", str(tmp_path)])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert len(lines) == 2 and all(" aux " in ln and " drop " in ln
                                   and " util " in ln for ln in lines)


def test_serve_runs_llama4_reduced_on_the_cpu(capsys):
    """``launch.serve`` on reduced llama4 (dense and MoE blocks
    alternating): ids in range, no kernel launched."""
    kc.reset_launches()
    ids = serve.main(["--device", "cpu", "--arch", LLAMA4, "--reduced",
                      "--batch", "2", "--prompt-len", "9", "--gen", "3"])
    assert ids.shape == (2, 3) and bool(((ids >= 0) & (ids < 256)).all())
    assert "sample output ids:" in capsys.readouterr().out
    assert not any(kc.launches.values())
