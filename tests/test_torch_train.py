"""Port parity, the LM training slice: the schedules, AdamW, the data
stream and its prefetcher, ``lm.loss_fn`` and its gradients, one trainer
step, the remat policies, the crash-and-restart drill and the training
CLIs, against the JAX package on the CPU.

Inputs come from numpy with a seed (or from the reference's own
initialiser, carried across with ``convert``).  Tolerances, each with
its reason:
* schedules: 1e-6 relative (float32 ``cos`` in the last ulp);
* AdamW over 5 steps: 1e-6 relative on params, m, v, grad_norm and
  clip_scale (``b ** count`` in float32 may differ from XLA's ``pow`` in
  the last ulp), bf16 leaves within one bf16 ulp (a flip of the final
  rounding); count exact;
* batches bitwise;
* loss and gradients: internlm2 and falcon-mamba (Mamba-1, with the
  published A of ``general_a``) within 1e-5 (loss relative, each gradient
  of its leaf's largest |g|): float32 sums in another order (falcon's
  worst leaf measured 1.2e-6, and JAX's own gradients move by up to 1e-6
  of a leaf's largest when the weights move by 1e-7 of themselves); zamba2
  within 1e-5 (loss) and 5e-3 of each leaf's largest |g|: the reduced
  zamba2 is ill-conditioned (a 1e-7 relative change of the weights moves
  JAX's own gradients by 2e-3 of a leaf's largest), and the port's plain
  scan sums in another order than ``scan_chunked``;
* two trainer steps (the first at rate 0, the second at the peak rate
  lr from the reference's state after the first): m within 1e-5 of each
  leaf's largest |m|, v within 1e-5 relative to its largest, parameters
  after the first step unchanged, after the second within 1e-3 lr where
  |m| is at least 1e-2 of its leaf's largest, else within 5e-2 lr
  (AdamW's step is about lr m / sqrt(v), which amplifies noise where
  g ~ 0);
* the remat policies and the restarted run: bitwise.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.data import pipeline as jdp  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import convert, train_lm  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.data import pipeline as dp  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm, ssm  # noqa: E402
from repro_torch.models import spec as sp  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.runtime import (FailureInjector, InjectedFailure,  # noqa: E402
                                 TrainRunner)
from test_torch_lm import with_general_a  # noqa: E402

ARCHS = ["internlm2-1.8b", "zamba2-2.7b", "falcon-mamba-7b"]
CPU = "cpu"
SHAPE = (2, 32)   # batch, sequence of the loss tests


def _np(x) -> np.ndarray:
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _host_batch(cfg, seed=0, step=0):
    return jdp.batch_at(cfg, jbase.ShapeConfig("t", SHAPE[1], SHAPE[0],
                                               "train"), seed, step)


# ---------------------------------------------------------------------------
# Shapes, schedules, AdamW
# ---------------------------------------------------------------------------

def test_shapes_match_the_jax_package():
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}


@pytest.mark.parametrize("name", ["warmup_cosine", "constant"])
def test_schedules_match_jax(name):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    for step in range(0, 121, 3):
        want = getattr(jsched, name)(jnp.int32(step), **kw)
        got = getattr(schedules, name)(torch.tensor(step, dtype=torch.int32),
                                       **kw)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _leaf_tree(rng):
    """A nested tree of random leaves, one of them bfloat16."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"a": f(3, 5), "b": {"w": f(7), "x": f(2, 3, 4)},
            "c": jnp.asarray(f(6, 2), jnp.bfloat16)}


def _to_torch(tree):
    return convert.lm_params_from_jax(tree, device=CPU)


def test_adamw_update_matches_jax_over_five_steps():
    rng = np.random.default_rng(0)
    jp = jax.tree.map(jnp.asarray, _leaf_tree(rng))
    tp = _to_torch(jp)
    jstate, tstate = jadamw.init(jp), adamw.init(tp)
    scales = []
    for step in range(5):
        # Large gradients on odd steps, so clipping binds there.
        g = jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32)
            * (10.0 if step % 2 else 0.1), x.dtype), jp)
        jlr = jsched.warmup_cosine(jstate.count, peak_lr=1e-2,
                                   warmup_steps=2, total_steps=5)
        tlr = schedules.warmup_cosine(tstate.count, peak_lr=1e-2,
                                      warmup_steps=2, total_steps=5)
        jp, jstate, jm = jadamw.update(g, jstate, jp, lr=jlr)
        tp, tstate, tm = adamw.update(_to_torch(g), tstate, tp, lr=tlr)
        for k in ("grad_norm", "clip_scale"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-6)
        scales.append(float(tm["clip_scale"]))
        assert int(tstate.count) == int(jstate.count) == step + 1
        assert tstate.count.dtype == torch.int32
        for want, got in ((jp, tp), (jstate.m, tstate.m),
                          (jstate.v, tstate.v)):
            for w, g_ in zip(jax.tree.leaves(want), sp.tree_leaves(got)):
                bf16 = w.dtype == jnp.bfloat16
                assert g_.dtype == (torch.bfloat16 if bf16 else torch.float32)
                np.testing.assert_allclose(
                    g_.float().numpy(), _np(w), rtol=2**-8 if bf16 else 1e-6,
                    atol=0 if bf16 else 1e-7)
    assert min(scales) < 1.0 and max(scales) == 1.0


def test_adamw_state_shapes_and_global_norm():
    params = {"w": torch.zeros(3, 4, dtype=torch.bfloat16),
              "b": {"x": torch.zeros(5)}}
    shapes = adamw.state_shapes(params)
    assert shapes.count.shape == () and shapes.count.dtype == torch.int32
    assert shapes.m["w"].shape == (3, 4) and shapes.v["b"]["x"].dtype == \
        torch.float32 and shapes.m["w"].device.type == "meta"
    tree = {"a": torch.full((4,), 3.0), "b": torch.full((1,), 4.0,
                                                        dtype=torch.bfloat16)}
    assert float(adamw.global_norm(tree)) == pytest.approx(
        float(np.sqrt(4 * 9 + 16)))


def test_adamw_leaves_its_arguments_unchanged():
    params = {"w": torch.ones(4)}
    state = adamw.init(params)
    new_p, new_s, _ = adamw.update({"w": torch.ones(4)}, state, params,
                                   lr=0.1)
    assert torch.equal(params["w"], torch.ones(4))
    assert int(state.count) == 0 and not state.m["w"].any()
    assert int(new_s.count) == 1 and not torch.equal(new_p["w"], params["w"])


# ---------------------------------------------------------------------------
# The data stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_batches_and_stream_are_the_references_bitwise(arch):
    cfg, jcfg = C.get(arch).reduced(), JC.get(arch).reduced()
    shape = base.ShapeConfig("t", 16, 3, "train")
    jshape = jbase.ShapeConfig("t", 16, 3, "train")
    for seed, step in ((0, 0), (5, 17), (7, 123456)):
        got = dp.batch_at(cfg, shape, seed, step)
        want = jdp.batch_at(jcfg, jshape, seed, step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    got = dp.batch_at(cfg, shape, 1, 2, batch_override=5)
    np.testing.assert_array_equal(
        got["tokens"], jdp.batch_at(jcfg, jshape, 1, 2,
                                    batch_override=5)["tokens"])
    for (s1, b1), (s2, b2) in zip(
            [next(it) for it in [dp.stream(cfg, shape, 3, start_step=4)] * 3],
            [next(it) for it in [jdp.stream(jcfg, jshape, 3, 4)] * 3]):
        assert s1 == s2
        np.testing.assert_array_equal(b1["targets"], b2["targets"])


def test_prefetcher_preserves_order_and_places_batches():
    def gen():
        for i in range(20):
            yield i, {"x": np.full((2,), i, np.int32),
                      "f": np.full((1,), i, np.float32)}

    out = list(dp.Prefetcher(gen(), depth=2, device=CPU))
    assert [(s, int(b["x"][0])) for s, b in out] == [(i, i) for i in
                                                      range(20)]
    assert out[0][1]["x"].dtype == torch.int64
    assert out[0][1]["f"].dtype == torch.float32


def test_prefetcher_applies_back_pressure():
    """The producer runs at most ``depth`` batches ahead of the consumer,
    plus the one it holds while blocked on the full queue."""
    produced = []

    def gen():
        for i in range(12):
            produced.append(i)
            yield i, {"x": np.zeros(1)}

    depth = 3
    it = dp.Prefetcher(gen(), depth=depth, place=lambda b: b)
    for i in range(12):
        time.sleep(0.02)
        step, _ = next(it)
        assert step == i
        assert len(produced) <= i + 1 + depth + 1
    with pytest.raises(StopIteration):
        next(it)


def test_poisson_inputs_are_the_references_numpy_stream():
    """The reference draws its generator's seed from a JAX key
    (``jax.random.randint(key, (), 0, 2**31)``, whose bound overflows
    int32 under jax 0.9.0) and then runs this numpy stream; the port takes
    that integer seed."""
    got = dp.poisson_inputs(1234, 5, 4, 6, 0.3)
    want = (np.random.default_rng(1234).random((5, 4, 6)) < 0.3)
    assert got.dtype == np.float32 and got.shape == (5, 4, 6)
    np.testing.assert_array_equal(got, want.astype(np.float32))


# ---------------------------------------------------------------------------
# The loss, its gradients, one step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, port cfg, JAX params, port params, host batch, JAX loss,
    JAX metrics, JAX gradients) of a reduced arch."""
    arch = request.param
    jcfg, cfg = JC.get(arch).reduced(), C.get(arch).reduced()
    jp = with_general_a(jcfg, jlm.init(jax.random.PRNGKey(0), jcfg))
    batch = _host_batch(jcfg)
    jb = jax.tree.map(jnp.asarray, batch)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, jb), has_aux=True))(jp)
    tp = convert.lm_params_from_jax(jp, device=CPU)
    return arch, cfg, jp, tp, batch, jl, jm, jg


def _port_grads(cfg, params, batch, remat):
    p = sp.tree_map(lambda x: x.detach().clone().requires_grad_(True),
                    params)
    loss, metrics = lm.loss_fn(cfg, p, dp.to_device(batch, CPU), remat=remat)
    return loss.detach(), metrics, torch.autograd.grad(loss,
                                                       sp.tree_leaves(p))


def test_loss_and_every_gradient_match_jax(model):
    arch, cfg, _, tp, batch, jl, jm, jg = model
    loss, metrics, grads = _port_grads(cfg, tp, batch, remat=True)
    assert set(metrics) == set(jm) == {"ce_loss", "loss"}
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce_loss"].detach()),
                               float(jm["ce_loss"]), rtol=1e-5)
    tol = 5e-3 if arch == "zamba2-2.7b" else 1e-5
    leaves = jax.tree.leaves(jg)
    assert len(leaves) == len(grads)
    for want, got in zip(leaves, grads):
        want = _np(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("policy", ["full", "dots", "none"])
def test_remat_policies_give_bitwise_equal_gradients(model, policy):
    _, cfg, _, tp, batch, *_ = model
    want = _port_grads(cfg, tp, batch, remat=False)
    got = _port_grads(dataclasses.replace(cfg, remat_policy=policy), tp,
                      batch, remat=True)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)


def test_remat_policy_names(monkeypatch):
    """``remat`` is a bool, as in the reference, and ``cfg.remat_policy``
    alone chooses the policy: "full" and "dots" run each repeat's blocks
    again in the backward, "none" (or ``remat=False`` under any policy)
    runs them once."""
    from repro_torch.models import transformer as tfm

    calls = []
    block = tfm._apply_block
    monkeypatch.setattr(tfm, "_apply_block",
                        lambda *a, **k: calls.append(1) or block(*a, **k))
    cfg = C.get("internlm2-1.8b").reduced()
    assert C.get("internlm2-1.8b").remat_policy == "full"
    params = lm.init(torch.Generator().manual_seed(0), cfg, device=CPU)
    batch = dp.to_device(_host_batch(cfg), CPU)
    for policy, remat, runs in (("full", True, 2), ("dots", True, 2),
                                ("none", True, 1), ("full", False, 1),
                                ("dots", False, 1)):
        calls.clear()
        c = dataclasses.replace(cfg, remat_policy=policy)
        p = sp.tree_map(lambda x: x.clone().requires_grad_(True), params)
        lm.loss_fn(c, p, batch, remat=remat)[0].backward()
        assert len(calls) == runs * cfg.n_layers, (policy, remat)


def _step_params_close(rows, lr):
    """Parameters after a step at rate ``lr`` > 0: within 1e-3 lr where
    |m| is at least 1e-2 of its leaf's largest (the gradients agree within
    1e-5 of the leaf's largest, so m / sqrt(v) within 1e-3 there), and
    within 5e-2 lr elsewhere, where g ~ 0 lets m / sqrt(v) swing.  The
    largest gaps seen were 1.2e-4 lr and 1.1e-4 lr, an ulp of the
    largest parameters."""
    moved = 0.0
    for w, g, m, old in rows:
        w, g, m = _np(w), g.numpy(), np.abs(_np(m))
        moved = max(moved, float(np.abs(w - _np(old)).max()))
        firm = m >= 1e-2 * m.max()
        np.testing.assert_allclose(g[firm], w[firm], rtol=0, atol=1e-3 * lr)
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-2 * lr)
    # The step moved the parameters, so the comparison above is not one
    # of unchanged leaves.
    assert moved > 0.1 * lr


def test_one_make_step_matches_jax():
    """Two steps of reduced internlm2 from the reference's initial state.
    The first runs at rate 0 (warm-up from count 0), so it fills m and v
    and leaves the parameters as they were; the second starts from the
    reference's state after the first and runs at the peak rate, so it
    holds the path from the rate to the parameters (bias correction, eps,
    the decoupled decay) against the reference."""
    jcfg, cfg = (JC.get("internlm2-1.8b").reduced(),
                 C.get("internlm2-1.8b").reduced())
    kw = dict(peak_lr=1e-3, total_steps=10)
    jstep = jax.jit(jtrain.make_step(jcfg, None, **kw))
    tstep = train.make_step(cfg, **kw)
    jstate = jtrain.build_train_state(jax.random.PRNGKey(1), jcfg)
    for count in (0, 1):
        lr = float(jsched.warmup_cosine(count, warmup_steps=1,
                                        total_steps=10, peak_lr=1e-3))
        assert lr == (0.0 if count == 0 else np.float32(1e-3))
        tstate = convert.train_state_from_jax(jstate, device=CPU)
        batch = _host_batch(jcfg, seed=2, step=3 + count)
        jnew, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tnew, tmet = tstep(tstate, dp.to_device(batch, CPU))
        # The step leaves its input state as it was.
        for a, b in zip(sp.tree_leaves(tstate["params"]),
                        jax.tree.leaves(jstate["params"])):
            np.testing.assert_array_equal(a.numpy(), _np(b))
        assert int(tnew["opt"].count) == int(jnew["opt"].count) == count + 1
        for k in ("loss", "ce_loss", "grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-5)
        m_leaves = jax.tree.leaves(jnew["opt"].m)
        for name, want, got in (
                ("m", m_leaves, sp.tree_leaves(tnew["opt"].m)),
                ("v", jax.tree.leaves(jnew["opt"].v),
                 sp.tree_leaves(tnew["opt"].v))):
            for w, g in zip(want, got):
                w = _np(w)
                np.testing.assert_allclose(
                    g.numpy(), w, rtol=0,
                    atol=1e-5 * float(np.abs(w).max()), err_msg=name)
        new = list(zip(jax.tree.leaves(jnew["params"]),
                       sp.tree_leaves(tnew["params"]), m_leaves,
                       jax.tree.leaves(jstate["params"])))
        if count == 0:
            for w, g, _, old in new:
                np.testing.assert_array_equal(_np(w), _np(old))
                np.testing.assert_array_equal(g.numpy(), _np(old))
        else:
            _step_params_close(new, lr)
        jstate = jnew


def test_train_state_crosses_the_two_checkpoint_stores(tmp_path):
    """A trainer state saved by the reference's store restores into the
    port's structure (the AdamWState fields give the same keys), bf16
    leaves included."""
    jcfg = dataclasses.replace(JC.get("internlm2-1.8b").reduced(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(C.get("internlm2-1.8b").reduced(),
                              dtype="bfloat16")
    jstate = jtrain.build_train_state(jax.random.PRNGKey(4), jcfg)
    jckpt.save(jstate, str(tmp_path), 7)
    target = train.build_train_state(torch.Generator().manual_seed(0), cfg,
                                     device=CPU)
    got = ckpt.restore(str(tmp_path), ckpt.latest_step(str(tmp_path)),
                       target)
    want = convert.train_state_from_jax(jstate, device=CPU)
    assert isinstance(got["opt"], adamw.AdamWState)
    for a, b in zip(ckpt.tree_leaves(got), ckpt.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# Fault drills and the CLIs
# ---------------------------------------------------------------------------

def _drill_step(cfg, seed):
    step = train.make_step(cfg, peak_lr=1e-3, total_steps=10, remat=False)
    shape = base.ShapeConfig("t", 16, 2, "train")

    def step_fn(state, i):
        return step(state, dp.to_device(dp.batch_at(cfg, shape, seed, i),
                                        CPU))[0]

    return step_fn


def test_crash_restart_bitwise_identical(tmp_path):
    """The drill of ``tests/test_fault.py``: a run killed at step 7 and
    restarted from its last committed checkpoint ends bitwise where an
    uninterrupted run ends."""
    cfg = C.get("internlm2-1.8b").reduced()
    init = train.build_train_state(torch.Generator().manual_seed(0), cfg,
                                   device=CPU)
    step_fn = _drill_step(cfg, seed=0)
    want = TrainRunner(step_fn=step_fn, ckpt_dir=str(tmp_path / "ref"),
                       ckpt_every=3, async_ckpt=False).run(init, 10)
    d = str(tmp_path / "crash")
    with pytest.raises(InjectedFailure):
        TrainRunner(step_fn=step_fn, ckpt_dir=d, ckpt_every=3,
                    async_ckpt=False,
                    injector=FailureInjector(fail_at_step=7)).run(init, 10)
    got = TrainRunner(step_fn=step_fn, ckpt_dir=d, ckpt_every=3,
                      async_ckpt=False).run(init, 10)
    assert int(got["opt"].count) == 10
    for a, b in zip(ckpt.tree_leaves(want), ckpt.tree_leaves(got)):
        assert torch.equal(a, b)


def test_restart_from_scratch_when_no_checkpoint(tmp_path):
    cfg = C.get("internlm2-1.8b").reduced()
    init = train.build_train_state(torch.Generator().manual_seed(0), cfg,
                                   device=CPU)
    runner = TrainRunner(step_fn=_drill_step(cfg, 0),
                         ckpt_dir=str(tmp_path / "x"), ckpt_every=100,
                         async_ckpt=False)
    state, start = runner.resume_or(init)
    assert start == 0 and state is init


def test_train_cli_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--log-every", "1", "--ckpt-every", "2", "--ckpt-dir",
            str(tmp_path)]
    first = train.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "step     0  loss " in out and "gnorm" in out and "tok/s" in out
    assert out.rstrip().endswith("done")
    assert ckpt.latest_step(str(tmp_path)) == 2
    second = train.main(argv + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step     4  loss " in out
    assert int(first["opt"].count) == 3 and int(second["opt"].count) == 5


def test_train_lm_tiny_preset_runs_on_the_cpu(tmp_path, capsys):
    state = train_lm.main(["--device", "cpu", "--steps", "2", "--ckpt-dir",
                           str(tmp_path)])
    out = capsys.readouterr().out
    assert "config lm-tiny: 1.5M params, batch 8x64" in out
    assert "step    1  loss " in out and int(state["opt"].count) == 2
    big = train_lm.preset_config("100m")
    assert (big.d_model, big.n_layers, big.vocab_size) == (768, 12, 32000)


def test_ssm_apply_trains_through_the_scan_function(monkeypatch):
    """A backward through ``ssm_apply`` goes through the ``SSMScanHeads``
    autograd Function (the plain forward with checkpoints, then the
    chunked plain backward on the CPU), once per call, never through the
    per-channel ``ssm_scan_bwd``, and its gradients are nonzero; under
    no_grad the scan is the single forward call."""
    from repro_torch.kernels.ssm_scan import ops as scan_ops

    calls = []
    fwd, bwd = scan_ops.ssm_scan_fwd, scan_ops.ssm_scan_heads_bwd
    monkeypatch.setattr(scan_ops, "ssm_scan_fwd", lambda *a, **k: calls.append(
        ("fwd", k.get("with_states", False))) or fwd(*a, **k))
    monkeypatch.setattr(scan_ops, "ssm_scan_heads_bwd",
                        lambda *a, **k: calls.append(("bwd", None))
                        or bwd(*a, **k))
    monkeypatch.setattr(scan_ops, "ssm_scan_bwd", lambda *a, **k: calls.append(
        ("per-channel bwd", None)))
    cfg = C.get("zamba2-2.7b").reduced()
    p = sp.init_tree(torch.Generator().manual_seed(0), ssm.ssm_spec(cfg),
                     torch.float32, CPU)
    p = sp.tree_map(lambda w: w.requires_grad_(True), p)
    x = torch.randn(1, 70, cfg.d_model)
    y = ssm.ssm_apply(cfg, p, x)
    grads = torch.autograd.grad(y.sum(), [p["A_log"], p["w_in_x"], p["D"]])
    assert calls == [("fwd", True), ("bwd", None)]
    assert all(bool(g.abs().sum() > 0) for g in grads)
    calls.clear()
    with torch.no_grad():
        assert torch.equal(ssm.ssm_apply(cfg, p, x), y.detach())
    assert calls == [("fwd", False)]


def test_mamba1_ssm_apply_trains_through_the_per_channel_function(
        monkeypatch):
    """A backward through falcon-mamba's ``ssm_apply`` (Mamba-1: A [di,
    N] with no constant row) goes through ``SSMScan``: the plain forward
    with checkpoints, then the per-channel plain backward
    (``ssm_scan_bwd``), once per call, never the per-head
    ``ssm_scan_heads_bwd``; every parameter's gradient is nonzero."""
    from repro_torch.kernels.ssm_scan import ops as scan_ops

    calls = []
    fwd, bwd = scan_ops.ssm_scan_fwd, scan_ops.ssm_scan_bwd
    monkeypatch.setattr(scan_ops, "ssm_scan_fwd", lambda *a, **k: calls.append(
        ("fwd", k.get("with_states", False))) or fwd(*a, **k))
    monkeypatch.setattr(scan_ops, "ssm_scan_bwd",
                        lambda *a, **k: calls.append(("bwd", None))
                        or bwd(*a, **k))
    monkeypatch.setattr(scan_ops, "ssm_scan_heads_bwd",
                        lambda *a, **k: calls.append(("heads bwd", None)))
    cfg = C.get("falcon-mamba-7b").reduced()
    p = sp.init_tree(torch.Generator().manual_seed(0), ssm.ssm_spec(cfg),
                     torch.float32, CPU)
    n = cfg.ssm_state
    p["A_log"] = torch.log(torch.arange(1, n + 1, dtype=torch.float32)
                           ).expand(cfg.d_inner, n).clone()
    p = sp.tree_map(lambda w: w.requires_grad_(True), p)
    x = torch.randn(1, 70, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y = ssm.ssm_apply(cfg, p, x)
    grads = torch.autograd.grad(y.sum(), sp.tree_leaves(p))
    assert calls == [("fwd", True), ("bwd", None)]
    assert all(bool(g.abs().sum() > 0) for g in grads)
