"""Port parity, the learning path: the surrogate spike, the LIF step's
gradient, STDP, ``run_plastic`` and the dense (differentiable) path of
``repro_torch`` against the JAX package on the CPU.

Spike trains are equal and integer stats bitwise.  Weights and traces
agree within 1e-5 (STDP's decay ``exp(-1/tau)`` and the crossbar sums of
non-dyadic learnt weights are computed by PyTorch and by XLA in their own
ways); gradients within the tolerance each test states.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import delays as jdl  # noqa: E402
from repro.core import pulse_comm as jpc  # noqa: E402
from repro.core import routing as jrt  # noqa: E402
from repro.snn import network as jnet  # noqa: E402
from repro.snn import neuron as jnr  # noqa: E402
from repro.snn import stdp as jsd  # noqa: E402
from repro.snn import surrogate as jsg  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import stdp_demo  # noqa: E402
from repro_torch.core import delays as dl  # noqa: E402
from repro_torch.core import pulse_comm as pc  # noqa: E402
from repro_torch.core import routing as rt  # noqa: E402
from repro_torch.snn import network as net  # noqa: E402
from repro_torch.snn import neuron as nr  # noqa: E402
from repro_torch.snn import stdp as sd  # noqa: E402
from repro_torch.snn import surrogate as sg  # noqa: E402
from repro_torch.snn import synapse as sy  # noqa: E402

ATOL = 1e-5


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def same(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.detach().numpy(),
                                  err_msg=msg)


def close(want, got, atol=ATOL, rtol=0.0, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# surrogate and the LIF gradient
# ---------------------------------------------------------------------------

def test_spike_surrogate_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 0.5, 61), [0.0, -0.0, 1e-8]]
                       ).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    jy, jvjp = jax.vjp(jsg.spike_surrogate, jnp.asarray(x))
    xt = T(x).requires_grad_()
    y = sg.spike_surrogate(xt)
    (gx,) = torch.autograd.grad(y, xt, T(g))
    same(jy, y)
    close(jvjp(jnp.asarray(g))[0], gx, atol=0, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_lif_step_gradient_matches_jax_vjp(seed):
    """The autograd ``lif_step``'s backward against ``jax.vjp`` of the
    reference's ``neuron.lif_step`` under the surrogate, with respect to
    ``v``, ``current``, ``tau_m``, ``v_th``, ``v_reset`` and ``v_rest``,
    on lanes that are refractory, that spike and that stay below."""
    rng = np.random.default_rng(seed)
    shape = (3, 16)
    f32 = lambda *a: rng.normal(*a, shape).astype(np.float32)  # noqa: E731
    v, cur = f32(0.4, 0.7), f32(0.5, 0.6)
    tau, v_th = rng.uniform(2, 20, shape).astype(np.float32), f32(1.0, 0.1)
    v_reset, v_rest = f32(-0.1, 0.05), f32(0.05, 0.05)
    refrac = rng.choice([0, 0, 1, 2], shape).astype(np.int32)
    refrac_p = np.full(shape, 2, np.int32)
    g_v, g_s = f32(0, 1), f32(0, 1)

    def jfn(v, cur, tau, v_th, v_reset, v_rest):
        state, spk = jnr.lif_step(
            jnr.LIFState(v, jnp.asarray(refrac)), cur,
            jnr.LIFParams(tau, v_th, v_reset, v_rest, jnp.asarray(refrac_p)))
        return state.v, spk

    diff = (v, cur, tau, v_th, v_reset, v_rest)
    (jv, js), vjp = jax.vjp(jfn, *map(jnp.asarray, diff))
    want = vjp((jnp.asarray(g_v), jnp.asarray(g_s)))

    xs = [T(x).requires_grad_() for x in diff]
    state, spk = nr.lif_step(
        nr.LIFState(xs[0], T(refrac)), xs[1],
        nr.LIFParams(xs[2], xs[3], xs[4], xs[5], T(refrac_p)))
    got = torch.autograd.grad((state.v, spk), xs, (T(g_v), T(g_s)))
    same(js, spk, "spikes")
    assert 0 < int(spk.sum()) < spk.numel() and (refrac > 0).any()
    for name, w, g in zip(("v", "current", "tau_m", "v_th", "v_reset",
                           "v_rest"), want, got):
        close(w, g, atol=1e-7, rtol=1e-5, msg=name)


# ---------------------------------------------------------------------------
# STDP
# ---------------------------------------------------------------------------

def test_stdp_step_matches_jax():
    rng = np.random.default_rng(3)
    n_chips, n_in, n = 3, 12, 10
    cfg = sd.STDPConfig(tau_minus=5.0, a_plus=0.03)
    jcfg = jsd.STDPConfig(**dataclasses.asdict(cfg))
    jstate = jsd.STDPState(*(jnp.asarray(rng.random((n_chips, m)),
                                         jnp.float32) for m in (n_in, n)))
    state = convert.stdp_state_from_jax(jstate, device="cpu")
    w = rng.uniform(-1, 1, (n_chips, n_in, n)).astype(np.float32)
    jw, tw = jnp.asarray(w), T(w)
    step = jax.vmap(lambda s, pre, post, ww: jsd.step(jcfg, s, pre, post, ww))
    for _ in range(5):
        pre = rng.integers(0, 3, (n_chips, n_in)).astype(np.float32)
        post = (rng.random((n_chips, n)) < 0.3).astype(np.float32)
        jstate, jw = step(jstate, jnp.asarray(pre), jnp.asarray(post), jw)
        state, tw = sd.step(cfg, state, T(pre), T(post), tw)
        close(jstate.x_pre, state.x_pre, atol=1e-6)
        close(jstate.x_post, state.x_post, atol=1e-6)
        close(jw, tw, atol=1e-6)


@pytest.mark.parametrize("pre_first,sign", [(True, 1), (False, -1)])
def test_stdp_window_sign(pre_first, sign):
    """Pre before post potentiates, post before pre depresses."""
    cfg, n = sd.STDPConfig(), 4
    state, w = sd.init(n, n), torch.zeros(n, n)
    for t in range(60):
        phase = t % 10
        first, second = (phase == 0), (phase == 2)
        pre = torch.full((n,), float(first if pre_first else second))
        post = torch.full((n,), float(second if pre_first else first))
        state, w = sd.step(cfg, state, pre, post, w)
    assert sign * float(w.mean()) > 0


# ---------------------------------------------------------------------------
# run_plastic
# ---------------------------------------------------------------------------

def _random_net(model="lif", b=1, comm_mode="event", seed=0, **extra):
    """LIF, fan-out 1, full mode with the rate-limited merge; dyadic
    initial weights (exact crossbar sums)."""
    comm_kw = dict(n_chips=4, neurons_per_chip=32, n_inputs_per_chip=32,
                   event_capacity=32, bucket_capacity=8, ring_depth=16,
                   superstep=b, fanout=1, mode="full", buckets_per_chip=2,
                   merge_rate=3, merge_depth=8, **extra)
    jcfg = jnet.NetworkConfig(comm=jpc.PulseCommConfig(**comm_kw),
                              neuron_model=model, comm_mode=comm_mode)
    cfg = net.NetworkConfig(comm=pc.PulseCommConfig(**comm_kw),
                            neuron_model=model, comm_mode=comm_mode)
    jparams = jnet.init_params(jax.random.PRNGKey(seed + b), jcfg)
    rng = np.random.default_rng(seed + b)
    w = np.round(rng.normal(0, 0.5, (4, 32, 32)) * 16) / 16
    jparams = jparams._replace(crossbar=jparams.crossbar._replace(
        w=jnp.asarray(w, jnp.float32)))
    ext = (rng.random((16, 4, 32)) < 0.2).astype(np.float32)
    return jcfg, cfg, jparams, ext


def _check_stats(jstats, stats):
    for f in jstats._fields:
        w, g = np.asarray(getattr(jstats, f)), getattr(stats, f)
        if f == "utilization":
            close(w, g, atol=1e-7)
        else:
            same(w, g, f)


@pytest.mark.parametrize("b", [1, 4])
def test_run_plastic_matches_jax(b):
    jcfg, cfg, jparams, ext = _random_net(b=b)
    jstate = jnet.init_state(jcfg, jparams)
    scfg = dict(a_plus=0.02, a_minus=0.015, tau_minus=5.0)
    jout = jax.jit(lambda p, s, e: jnet.run_plastic(
        jcfg, p, s, e, stdp_cfg=jsd.STDPConfig(**scfg)))(
        jparams, jstate, jnp.asarray(ext))
    jp, jfinal, jrec, jst = jout
    params = convert.params_from_jax(jparams, device="cpu")
    state = convert.state_from_jax(jstate, device="cpu")
    p, final, rec, st = net.run_plastic(cfg, params, state, ext,
                                        sd.STDPConfig(**scfg), device="cpu")
    same(jrec.spikes, rec.spikes, "spikes")
    close(jrec.voltage, rec.voltage)
    _check_stats(jrec.stats, rec.stats)
    close(jp.crossbar.w, p.crossbar.w)
    close(jst.x_pre, st.x_pre)
    close(jst.x_post, st.x_post)
    same(jfinal.ring.ring, final.ring.ring, "ring")
    same(jfinal.merge.words, final.merge.words, "merge queue")
    assert not torch.equal(p.crossbar.w, params.crossbar.w)
    assert int(rec.stats.sent.sum()) > 0
    # the network's parameters are not touched in place
    same(jparams.crossbar.w, params.crossbar.w)


def test_stdp_demo_separates_the_causal_pathway(capsys):
    a, b = stdp_demo.main(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"pathway A (causal)  mean weight: 0.300 -> {a:.3f}"
    assert lines[1] == f"pathway B (noise)   mean weight: 0.300 -> {b:.3f}"
    assert lines[-1] == ("STDP separated the causal pathway while pulses "
                         "crossed the network.")
    assert a > b
    # the reference's example, same network and rule
    cfg, params, state, ext = stdp_demo.setup("cpu")
    n = stdp_demo.N
    jcfg = jnet.NetworkConfig(comm=jpc.PulseCommConfig(**dataclasses.asdict(
        cfg.comm)))
    jparams = jnet.init_params(
        jax.random.PRNGKey(0), jcfg,
        table=jrt.feedforward_table(n, src_chip=0, dst_chip=1, delay=2))
    jparams = jparams._replace(crossbar=jparams.crossbar._replace(
        w=jnp.full((2, n, n), 0.3)))
    jp, _, _, _ = jnet.run_plastic(
        jcfg, jparams, jnet.init_state(jcfg, jparams), jnp.asarray(ext),
        stdp_cfg=jsd.STDPConfig(**dataclasses.asdict(stdp_demo.STDP)))
    w = np.asarray(jp.crossbar.w[0])
    assert abs(w[:n // 2].mean() - a) < 1e-5
    assert abs(w[n // 2:].mean() - b) < 1e-5


# ---------------------------------------------------------------------------
# dense mode
# ---------------------------------------------------------------------------

def test_dense_route_matches_jax_on_out_of_range_entries():
    """Destination chips -4, -1 and n_chips, delays outside [1, D] and
    addresses outside the ring: JAX's scatter wraps a negative chip once,
    then drops; delays outside [1, D] deliver nothing; addresses clip."""
    rng = np.random.default_rng(5)
    n_chips, n, d = 3, 8, 6
    comm = dict(n_chips=n_chips, neurons_per_chip=n, n_inputs_per_chip=n,
                ring_depth=d, fanout=2)
    shape = (n_chips, n, 2)
    table = jrt.RoutingTable(
        dest_chip=rng.choice([-4, -1, 0, 1, 2, 3], shape).astype(np.int32),
        dest_addr=rng.integers(-2, n + 2, shape).astype(np.int32),
        delay=rng.choice([-1, 0, 1, 3, 6, 7], shape).astype(np.int32),
        valid=rng.random(shape) < 0.8)
    spikes = (rng.random((n_chips, n)) < 0.6).astype(np.float32)
    ring = rng.integers(0, 3, (n_chips, d, n)).astype(np.float32)
    now = np.full((n_chips,), 5, np.int32)
    want = jnet.dense_route(jpc.PulseCommConfig(**comm), jnp.asarray(spikes),
                            jrt.RoutingTable(*map(jnp.asarray, table)),
                            jdl.DelayRing(jnp.asarray(ring), jnp.asarray(now)),
                            jnp.int32(5))
    got = net.dense_route(pc.PulseCommConfig(**comm), T(spikes),
                          rt.RoutingTable(*map(T, table)),
                          dl.DelayRing(T(ring), T(now)), T(np.int32(5)))
    same(want.ring, got.ring)
    assert not np.array_equal(np.asarray(want.ring), ring)


@pytest.mark.parametrize("b", [1, 4])
def test_dense_run_matches_jax(b):
    """Dense mode runs per step whatever the superstep, so T need not be a
    multiple of B."""
    jcfg, cfg, jparams, ext = _random_net(b=b, comm_mode="dense")
    ext = ext[:14]
    jstate = jnet.init_state(jcfg, jparams)
    jfinal, jrec = jax.jit(lambda p, s, e: jnet.run(jcfg, p, s, e))(
        jparams, jstate, jnp.asarray(ext))
    params = convert.params_from_jax(jparams, device="cpu")
    state = convert.state_from_jax(jstate, device="cpu")
    assert state.ring.ring.dtype == torch.float32
    final, rec = net.run(cfg, params, state, ext, device="cpu")
    same(jrec.spikes, rec.spikes, "spikes")
    close(jrec.voltage, rec.voltage)
    _check_stats(jrec.stats, rec.stats)
    same(jfinal.ring.ring, final.ring.ring, "ring")
    assert int(rec.spikes.sum()) > 0


def _ff_network(comm_mode, n=32, delay=2, w_target=0.6, drive_period=4,
                t=24):
    comm = pc.PulseCommConfig(n_chips=2, neurons_per_chip=n,
                              n_inputs_per_chip=n, event_capacity=n,
                              bucket_capacity=n, ring_depth=8)
    cfg = net.NetworkConfig(comm=comm, neuron_model="lif",
                            comm_mode=comm_mode)
    table = rt.feedforward_table(n, src_chip=0, dst_chip=1, delay=delay)
    params = net.init_params(torch.Generator().manual_seed(0), cfg,
                             table=table, device="cpu")
    w = np.zeros((2, n, n), np.float32)
    w[0] = 1.5 * np.eye(n)
    w[1] = w_target * np.eye(n)
    params = params._replace(crossbar=sy.Crossbar(w=T(w)))
    ext = np.zeros((t, 2, n), np.float32)
    ext[::drive_period, 0, :] = 1.0
    return cfg, params, net.init_state(cfg, params, device="cpu"), ext


def test_event_path_matches_dense_path():
    """With no drops the event pipeline and the dense bypass deliver the
    same spike trains (the reference's ``test_network.py`` case)."""
    outs = {}
    for mode in ("event", "dense"):
        cfg, params, state, ext = _ff_network(mode)
        _, rec = net.run(cfg, params, state, ext, device="cpu")
        outs[mode] = rec.spikes
    assert torch.equal(outs["event"], outs["dense"])
    assert int(outs["dense"][:, 1].sum()) > 0


def _training_setup():
    comm_kw = dict(n_chips=2, neurons_per_chip=8, n_inputs_per_chip=8,
                   event_capacity=8, bucket_capacity=8, ring_depth=4)
    jcfg = jnet.NetworkConfig(comm=jpc.PulseCommConfig(**comm_kw),
                              comm_mode="dense")
    cfg = net.NetworkConfig(comm=pc.PulseCommConfig(**comm_kw),
                            comm_mode="dense")
    table = jrt.feedforward_table(8, src_chip=0, dst_chip=1, delay=1)
    jparams = jnet.init_params(jax.random.PRNGKey(2), jcfg, table=table)
    ext = np.tile(np.array([1.0, 0.0], np.float32)[None, :, None],
                  (12, 1, 8))
    return jcfg, cfg, jparams, ext


def test_surrogate_gradient_matches_jax_and_training_lowers_the_loss():
    """The reference's BPTT test through the dense path: the gradient of
    the chip-1 rate loss with respect to the weights against ``jax.grad``
    (rtol 1e-4, atol 1e-6), then 20 steps of descent lower the loss."""
    jcfg, cfg, jparams, ext = _training_setup()
    params = convert.params_from_jax(jparams, device="cpu")

    def jloss(w):
        p = jparams._replace(crossbar=jparams.crossbar._replace(w=w))
        _, rec = jnet.run(jcfg, p, jnet.init_state(jcfg, p), jnp.asarray(ext))
        return (jnp.mean(rec.spikes[:, 1]) - 0.5) ** 2

    def loss(w):
        p = params._replace(crossbar=sy.Crossbar(w=w))
        _, rec = net.run(cfg, p, net.init_state(cfg, p, device="cpu"), ext,
                         device="cpu")
        return (rec.spikes[:, 1].mean() - 0.5) ** 2

    w = params.crossbar.w.clone().requires_grad_()
    l0 = loss(w)
    (g,) = torch.autograd.grad(l0, w)
    jg = jax.grad(jloss)(jparams.crossbar.w)
    np.testing.assert_allclose(float(l0.detach()),
                               float(jloss(jparams.crossbar.w)),
                               rtol=1e-6)
    close(jg, g, atol=1e-6, rtol=1e-4)
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
    for _ in range(20):
        w = (w - 5.0 * torch.autograd.grad(loss(w), w)[0]).detach()
        w.requires_grad_()
    assert float(loss(w).detach()) < float(l0.detach())


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

def test_convert_carries_stdp_state_and_a_float_ring():
    jcfg, _, jparams, _ = _random_net(comm_mode="dense")
    jstate = jnet.init_state(jcfg, jparams)
    jstate = jstate._replace(ring=jstate.ring._replace(
        ring=jstate.ring.ring + 0.5, now=jstate.ring.now + 3))
    state = convert.state_from_jax(jstate, device="cpu")
    assert state.ring.ring.dtype == torch.float32
    same(jstate.ring.ring, state.ring.ring)
    same(jstate.ring.now, state.ring.now)
    jst = jax.vmap(lambda _: jsd.init(32, 32))(jnp.arange(4))
    jst = jst._replace(x_pre=jst.x_pre + 0.25)
    st = convert.stdp_state_from_jax(jst, device="cpu")
    assert isinstance(st, sd.STDPState)
    same(jst.x_pre, st.x_pre)
    same(jst.x_post, st.x_post)
