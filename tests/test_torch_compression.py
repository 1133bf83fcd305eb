"""Port parity, the compressed-gradient data-parallel trainer
(``optim/compression.py``, ``launch/train.make_compressed_step``), against
the JAX package on the CPU.

* ``compress_leaf``: none and topk bitwise against the reference's, ties
  at the top-k threshold included; int8 bitwise when fed the reference's
  noise (``jax.random.uniform(key, shape, minval=-0.5, maxval=0.5)``);
  ``wire_bytes``, the telescoping test (within 1e-5, as the reference's)
  and the error-feedback convergence test of ``tests/test_optim.py``.
* ``compressed_psum`` over a data group of one rank (gloo processes of
  a (2, 1) ("model", "data") mesh) against the reference's inside
  ``jax.shard_map`` over one CPU device, each int8 leaf fed the
  reference's noise; over groups of 2 and 4 every rank draws the same
  noise, every rank gets the same bits, and the result is the mean of
  the ranks' own wires (bitwise at 2; within 1e-6 of the largest at 4,
  where gloo sums in another order).
* ``make_compressed_step(method="none")`` at world 2 on reduced internlm2
  with the reference's weights: every rank's parameters, moments and
  metrics bitwise equal, and within ``tests/test_torch_train.py``'s
  bounds of the reference's ``local_step`` rebuilt from its pieces
  (``jax.value_and_grad(lm.loss_fn)`` on each rank's half of the batch,
  ``compress_leaf`` under ``jax.random.split(key, n_leaves)``, the mean,
  ``warmup_cosine``, ``adamw.update``): the metrics within 1e-5 relative,
  m within 1e-5 of each leaf's largest |m| (the gradients' bound), v
  within 1e-5 relative to its largest; the first step (rate 0) leaves
  the parameters as they were, the second (from the reference's state,
  at the peak rate) moves them within 1e-3 lr where |m| is at least 1e-2
  of its leaf's largest, else 5e-2 lr.  The reference's own
  ``make_compressed_step`` raises under jax 0.9.0 (``shard_map``'s
  ``check_rep``), so it cannot be called here.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.data import pipeline as jdp  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcmp  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import spec as sp  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402

import torch_dist  # noqa: E402

FRAC = 0.05


def _np(x) -> np.ndarray:
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _leaf_tree(rng, scale=1.0):
    """Gradient-like leaves: float32 of three ranks, one bf16, one all
    zero, one of small integers (ties at any top-k threshold)."""
    return {
        "a": (scale * rng.standard_normal(64)).astype(np.float32),
        "b": (scale * rng.standard_normal((8, 16))).astype(np.float32),
        "c": (scale * rng.standard_normal((3, 5, 7))).astype(np.float32),
        "d": jnp.asarray(scale * rng.standard_normal((4, 32)),
                         jnp.bfloat16),
        "t": rng.integers(-3, 4, (10, 10)).astype(np.float32),
        "z": np.zeros(10, np.float32),
    }


def _torch(tree):
    return {k: (torch.as_tensor(np.asarray(v, np.float32)).to(torch.bfloat16)
                if np.asarray(v).dtype.name == "bfloat16"
                else torch.as_tensor(np.asarray(v)))
            for k, v in tree.items()}


def _jax_noise(key, tree):
    """The reference's int8 noise for each leaf, in its leaf order."""
    leaves = jax.tree.leaves(tree)
    keys = jax.random.split(key, len(leaves))
    return [torch.as_tensor(np.array(jax.random.uniform(
        k, g.shape, minval=-0.5, maxval=0.5))) for g, k in zip(leaves, keys)]


# ---------------------------------------------------------------------------
# The codecs, in-process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["none", "topk", "int8"])
def test_compress_leaf_matches_jax_bitwise(method):
    rng = np.random.default_rng(0)
    grads, res = _leaf_tree(rng), _leaf_tree(rng, 0.1)
    res = {k: _np(v) for k, v in res.items()}
    key = jax.random.PRNGKey(4)
    noises = _jax_noise(key, grads)
    keys = jax.random.split(key, len(grads))
    tg, tr = _torch(grads), _torch(res)
    # int8 runs eagerly: under jit XLA fuses acc - q scale into one FMA.
    leaf = jcmp.compress_leaf if method == "int8" else jax.jit(
        jcmp.compress_leaf, static_argnames=("method", "topk_frac"))
    for (k, g), jk, noise in zip(sorted(grads.items()), keys, noises):
        wire, r1 = leaf(jnp.asarray(g), jnp.asarray(res[k]), jk,
                        method=method, topk_frac=FRAC)
        if method == "int8":
            got = compression._compress(tg[k], tr[k], noise, method=method)
        else:
            got = compression.compress_leaf(tg[k], tr[k], None,
                                            method=method, topk_frac=FRAC)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(wire),
                                      err_msg=f"{method} {k}")
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(r1),
                                      err_msg=f"{method} {k}")
        assert got[0].dtype == got[1].dtype == torch.float32
    if method == "topk":
        # The integer leaf ties at its threshold: every tie is kept.
        wire, _ = compression.compress_leaf(tg["t"], tr["t"] * 0, None,
                                            method="topk", topk_frac=FRAC)
        kept = int((wire != 0).sum())
        assert kept > max(1, int(100 * FRAC))
        assert kept == int((tg["t"].abs() == 3).sum())


def test_int8_noise_comes_from_the_generator():
    g = torch.linspace(-1, 1, 50)
    r = torch.zeros(50)
    a = compression.compress_leaf(g, r, torch.Generator().manual_seed(3),
                                  method="int8")
    b = compression.compress_leaf(g, r, torch.Generator().manual_seed(3),
                                  method="int8")
    noise = torch.rand(50, generator=torch.Generator().manual_seed(3)) - 0.5
    c = compression._compress(g, r, noise, method="int8")
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)
    scale = g.abs().max() / 127
    q = torch.round(a[0] / scale)
    assert torch.equal(q * scale, a[0]) and q.abs().max() <= 127
    with pytest.raises(ValueError):
        compression.compress_leaf(g, r, None, method="fp8")


def test_compression_residual_telescopes():
    """wire + residual == grad + old residual (no signal lost), within
    1e-5 as the reference's test holds it."""
    key = jax.random.PRNGKey(3)
    g = torch.as_tensor(np.asarray(jax.random.normal(key, (128,))))
    r0 = torch.as_tensor(np.asarray(
        jax.random.normal(jax.random.fold_in(key, 1), (128,)) * 0.1))
    for method in ("int8", "topk", "none"):
        wire, r1 = compression.compress_leaf(
            g, r0, torch.Generator().manual_seed(3), method=method,
            topk_frac=0.05)
        np.testing.assert_allclose((wire + r1).numpy(), (g + r0).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_wire_bytes():
    grads = {"a": torch.zeros(1000), "b": torch.zeros(10, 10)}
    jgrads = {"a": jnp.zeros(1000), "b": jnp.zeros((10, 10))}
    for method in ("none", "int8", "topk"):
        assert compression.wire_bytes(grads, method=method) == \
            jcmp.wire_bytes(jgrads, method=method)
    assert compression.wire_bytes(grads, method="none") == 1100 * 4
    assert compression.wire_bytes(grads, method="int8") == 1100 + 8
    assert compression.wire_bytes(grads, method="topk", topk_frac=0.01) == \
        10 * 8 + 1 * 8


@pytest.mark.parametrize("method", ["int8", "topk"])
def test_error_feedback_compression_converges(method):
    """The reference's quadratic (its key 2), 400 steps of the port's
    AdamW on the port's compressed gradients with error feedback."""
    key = jax.random.PRNGKey(2)
    a = jax.random.normal(key, (32, 32)) / np.sqrt(32)
    h = torch.as_tensor(np.asarray(a @ a.T + 0.1 * jnp.eye(32)))
    x_star = torch.as_tensor(np.asarray(
        jax.random.normal(jax.random.fold_in(key, 1), (32,))))

    def loss(x):
        d = x - x_star
        return float(0.5 * d @ h @ d)

    params = {"x": torch.zeros(32)}
    state = adamw.init(params)
    ef = compression.ef_init(params)
    gen = torch.Generator().manual_seed(2)
    for _ in range(400):
        g = h @ (params["x"] - x_star)
        wire, res = compression.compress_leaf(g, ef.residual["x"], gen,
                                              method=method, topk_frac=0.1)
        ef = compression.EFState(residual={"x": res})
        params, state, _ = adamw.update({"x": wire}, state, params, lr=0.05,
                                        weight_decay=0.0)
    final, initial = loss(params["x"]), loss(torch.zeros(32))
    bound = 5e-2 if method == "int8" else 0.3
    assert final < bound and final < 0.05 * initial, (method, final, initial)


def test_ef_init_is_float32_zeros_like_the_params():
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16),
              "b": {"c": torch.ones(4)}}
    ef = compression.ef_init(params)
    assert ef.residual["w"].dtype == torch.float32
    assert torch.equal(ef.residual["b"]["c"], torch.zeros(4))


# ---------------------------------------------------------------------------
# compressed_psum in gloo processes
# ---------------------------------------------------------------------------

def _jax_compressed_psum(grads, res, key):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    out = {}
    for method in ("none", "int8", "topk"):
        f = jax.shard_map(
            lambda g, r, k, m=method: jcmp.compressed_psum(
                g, jcmp.EFState(residual=r), k, "data", method=m,
                topk_frac=FRAC),
            mesh=mesh, in_specs=(P(), P(), P()), out_specs=(P(), P()),
            check_vma=False)
        out[method] = jax.jit(f)(grads, res, key)
    return out


# The data groups of the compressed_psum cases, (spawned world, mesh): a
# group of one rank (a (2, 1) mesh whose "data" axis has size 1), of
# two and of four.
PSUM_MESHES = {1: (2, ((2, 1), ("model", "data"))),
               2: (2, ((2, 1), ("data", "model"))),
               4: (4, ((4, 1), ("data", "model")))}


def _psum_case(data_size, seed):
    rng = np.random.default_rng(seed)
    grads = [_leaf_tree(rng) for _ in range(data_size)]
    res = [{k: _np(v) for k, v in _leaf_tree(rng, 0.1).items()}
           for _ in range(data_size)]
    return grads, res, dict(grads=[_torch(g) for g in grads],
                            residual=[_torch(r) for r in res], frac=FRAC)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Two spawns of ``torch_dist.compress_worker``: world 2 runs the
    compressed_psum cases of data size 1 and 2 and the two compressed
    steps, world 4 the case of data size 4.  Returns (the psum cases'
    data, by data size; the reference's compressed_psum at data size 1;
    the reference's steps; each world's ranks' outputs)."""
    cases, want = {}, None
    for size, (_, mesh) in PSUM_MESHES.items():
        grads, res, case = _psum_case(size, 10 + size)
        case["mesh"] = mesh
        if size == 1:
            key = jax.random.PRNGKey(8)
            case["noise"] = _jax_noise(key, grads[0])
            want = _jax_compressed_psum(grads[0], res[0], key)
        cases[size] = case
    steps, jsteps = _compressed_step_data()
    ranks = {}
    for world in (2, 4):
        psum = {size: c for size, c in cases.items()
                if PSUM_MESHES[size][0] == world}
        data = dict(psum=psum, **({"steps": steps} if world == 2 else {}))
        ranks[world] = torch_dist.spawn(
            torch_dist.compress_worker, world,
            tmp_path_factory.mktemp(f"compress{world}"), data)
    return cases, want, jsteps, ranks


@pytest.fixture(scope="module")
def psum(spawned):
    cases, want, _, ranks = spawned
    return {size: (case, [r[size] for r in ranks[PSUM_MESHES[size][0]]],
                   want if size == 1 else None)
            for size, case in cases.items()}


def test_compressed_psum_over_one_rank_matches_jax(psum):
    """The reduced gradients bitwise; the residuals bitwise but int8's,
    within 1e-6 of the leaf's largest |g + r|: under ``jax.jit`` XLA
    contracts int8's acc - q scale into one fused multiply-add, which
    rounds once where the port rounds twice (eager, the residuals match
    bitwise: ``test_compress_leaf_matches_jax_bitwise``)."""
    data, ranks, want = psum[1]
    for method, (reduced, ef) in want.items():
        for got in (r[method] for r in ranks):
            for k in sorted(reduced):
                np.testing.assert_array_equal(got["reduced"][k].numpy(),
                                              np.asarray(reduced[k]),
                                              err_msg=f"{method} {k}")
                res, w = got["residual"][k].numpy(), np.asarray(
                    ef.residual[k])
                if method == "int8":
                    acc = data["grads"][0][k].float() + data["residual"][0][k]
                    np.testing.assert_allclose(
                        res, w, rtol=0,
                        atol=1e-6 * float(acc.abs().max()), err_msg=k)
                else:
                    np.testing.assert_array_equal(res, w,
                                                  err_msg=f"{method} {k}")


@pytest.mark.parametrize("size", [1, 2, 4])
def test_compressed_psum_is_the_mean_of_the_ranks_wires(psum, size):
    """At data size ``size``: every rank draws the same noise and gets the
    same bits, the mean of the group's own wires (bitwise up to 2 ranks,
    within 1e-6 of the largest at 4), and its residual telescopes."""
    data, ranks, _ = psum[size]
    for r in ranks[1:]:
        for a, b in zip(r["noise"], ranks[0]["noise"]):
            assert torch.equal(a, b)
    for method in ("none", "int8", "topk"):
        for k in sorted(data["grads"][0]):
            got = [r[method]["reduced"][k] for r in ranks]
            for x in got[1:]:
                assert torch.equal(x, got[0]), (method, k)
            wires = [ranks[i][method]["wire"][k] for i in range(size)]
            mean = sum(wires[1:], wires[0]) / size
            if size <= 2:
                assert torch.equal(got[0], mean), (method, k)
            else:
                np.testing.assert_allclose(
                    got[0].numpy(), mean.numpy(), rtol=0,
                    atol=1e-6 * float(mean.abs().max()))
            for rank, r in enumerate(ranks):
                i = rank % size
                res = r[method]["residual"][k]
                assert torch.equal(res, r[method]["own_residual"][k])
                acc = data["grads"][i][k].float() + data["residual"][i][k]
                np.testing.assert_allclose(
                    (r[method]["wire"][k] + res).numpy(), acc.numpy(),
                    rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# make_compressed_step at world 2 against the reference's local_step
# ---------------------------------------------------------------------------

KW = dict(peak_lr=1e-3, total_steps=10)


def _jax_local_step(jcfg, world, key):
    """The reference's ``local_step`` (``launch/train.py:67-85``) rebuilt
    from its pieces, the ranks run in turn: ``step(state, batch) -> (new
    state, metrics, lr)``."""

    @jax.jit
    def rank_wires(params, b):
        (_, m), g = jax.value_and_grad(
            lambda p: jlm.loss_fn(jcfg, p, b, None, remat=False),
            has_aux=True)(params)
        leaves, treedef = jax.tree.flatten(g)
        keys = jax.random.split(key, len(leaves))
        return [jcmp.compress_leaf(x, jnp.zeros(x.shape, jnp.float32), k,
                                   method="none")[0]
                for x, k in zip(leaves, keys)], m

    @jax.jit
    def update(wires, metrics, opt, params):
        treedef = jax.tree.structure(params)
        reduced = jax.tree.unflatten(treedef, [sum(ws) / world
                                               for ws in zip(*wires)])
        metrics = {k: sum(m[k] for m in metrics) / world
                   for k in metrics[0]}
        lr = jsched.warmup_cosine(
            opt.count, peak_lr=KW["peak_lr"],
            warmup_steps=max(KW["total_steps"] // 20, 1),
            total_steps=KW["total_steps"])
        new_params, new_opt, om = jadamw.update(reduced, opt, params, lr=lr)
        metrics.update(om)
        return {"params": new_params, "opt": new_opt}, metrics, lr

    def step(jstate, batch):
        n = batch["tokens"].shape[0] // world
        outs = [rank_wires(jstate["params"],
                           {k: jnp.asarray(v[r * n:(r + 1) * n])
                            for k, v in batch.items()})
                for r in range(world)]
        new, metrics, lr = update([w for w, _ in outs],
                                  [m for _, m in outs], jstate["opt"],
                                  jstate["params"])
        return new, metrics, float(lr)

    return step


def _compressed_step_data():
    """Two steps of reduced internlm2 at world 2: the workers' data and
    the reference's rebuilt steps (the second from the reference's state
    after the first), each (old state, new state, metrics, lr)."""
    jcfg, cfg = (JC.get("internlm2-1.8b").reduced(),
                 C.get("internlm2-1.8b").reduced())
    jstate = jax.jit(jtrain.build_train_state, static_argnums=1)(
        jax.random.PRNGKey(1), jcfg)
    shape = jbase.ShapeConfig("t", 32, 4, "train")
    states, batches, want = [], [], []
    jstep = _jax_local_step(jcfg, 2, jax.random.PRNGKey(0))
    for i in range(2):
        batch = jdp.batch_at(jcfg, shape, 2, 3 + i)
        states.append(convert.train_state_from_jax(jstate, device="cpu"))
        batches.append(batch)
        new, metrics, lr = jstep(jstate, batch)
        want.append((jstate, new, metrics, lr))
        jstate = new
    return dict(cfg=cfg, kw=KW, states=states, batches=batches), want


@pytest.fixture(scope="module")
def compressed_steps(spawned):
    _, _, want, ranks = spawned
    return want, [r["steps"] for r in ranks[2]]


def test_compressed_step_ranks_stay_equal(compressed_steps):
    _, (r0, r1) = compressed_steps
    for a, b in zip(r0, r1):
        for x, y in zip(sp.tree_leaves(a["state"]["params"]),
                        sp.tree_leaves(b["state"]["params"])):
            assert torch.equal(x, y)
        for f in ("m", "v"):
            for x, y in zip(sp.tree_leaves(getattr(a["state"]["opt"], f)),
                            sp.tree_leaves(getattr(b["state"]["opt"], f))):
                assert torch.equal(x, y)
        assert a["metrics"].keys() == b["metrics"].keys()
        for k in a["metrics"]:
            assert torch.equal(a["metrics"][k], b["metrics"][k])
        # "none" sends every bit: the residuals stay zero.
        for x in sp.tree_leaves(a["state"]["ef"].residual):
            assert x.dtype == torch.float32 and not x.any()


def test_compressed_step_matches_the_references_local_step(compressed_steps):
    want, (got, _) = compressed_steps
    for i, ((old, new, metrics, lr), out) in enumerate(zip(want, got)):
        assert lr == (0.0 if i == 0 else np.float32(KW["peak_lr"]))
        assert int(out["state"]["opt"].count) == int(new["opt"].count)
        assert set(out["metrics"]) == set(metrics)
        for k in metrics:
            np.testing.assert_allclose(float(out["metrics"][k]),
                                       float(metrics[k]), rtol=1e-5)
        m_leaves = jax.tree.leaves(new["opt"].m)
        for name, w_leaves, g_leaves in (
                ("m", m_leaves, sp.tree_leaves(out["state"]["opt"].m)),
                ("v", jax.tree.leaves(new["opt"].v),
                 sp.tree_leaves(out["state"]["opt"].v))):
            assert len(w_leaves) == len(g_leaves)
            for w, g in zip(w_leaves, g_leaves):
                w = _np(w)
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=0,
                    atol=1e-5 * float(np.abs(w).max()), err_msg=name)
        rows = zip(jax.tree.leaves(new["params"]),
                   sp.tree_leaves(out["state"]["params"]), m_leaves,
                   jax.tree.leaves(old["params"]))
        if i == 0:
            for w, g, _, o in rows:
                np.testing.assert_array_equal(g.numpy(), _np(o))
                np.testing.assert_array_equal(_np(w), _np(o))
            continue
        moved = 0.0
        for w, g, m, o in rows:
            w, g, m = _np(w), g.numpy(), np.abs(_np(m))
            moved = max(moved, float(np.abs(w - _np(o)).max()))
            firm = m >= 1e-2 * m.max()
            np.testing.assert_allclose(g[firm], w[firm], rtol=0,
                                       atol=1e-3 * lr)
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-2 * lr)
        assert moved > 0.1 * lr
