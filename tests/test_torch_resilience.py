"""Port parity, chip-failure recovery (``repro_torch.core.resilience``,
``repro_torch.runtime.ResilientRunner``): the detection and drill cases
of tests/test_resilience.py (but the ``psum`` heartbeat, which comes with
the multi-GPU transport), each run in both packages from the same
parameters (``convert.params_from_jax``) and inputs (numpy, seeded).

The drills (4 chips x 16 LIF on a ring, ``link_latency`` 0): kill chip 2
at step 7 under ``ResilientRunner`` with checkpoints every 3 steps.  The
records, the recoveries, the final state and the flight-recorder dumps
must equal JAX's: spikes and every integer bitwise, ``utilization``
within 1 f32 ulp, voltages within 1e-5 (``exp`` may differ in the last
bit).  The port's recovered run must also equal, from its resume point,
an uninterrupted run on the survivors started from the same checkpoint.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core import flowcontrol as jfc  # noqa: E402
from repro.core import pulse_comm as jpc  # noqa: E402
from repro.core import resilience as jrsl  # noqa: E402
from repro.core import topology as jtp  # noqa: E402
from repro.runtime import ResilientRunner as JResilientRunner  # noqa: E402
from repro.snn import network as jnet  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.core import flowcontrol as fc  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import pulse_comm as pc  # noqa: E402
from repro_torch.core import resilience as rsl  # noqa: E402
from repro_torch.runtime import (ChipFailure, RecoveryEvent,  # noqa: E402
                                 ResilientRunner)
from repro_torch.snn import network as net  # noqa: E402
from test_torch_topology import same_stats  # noqa: E402

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# Detection: heartbeat, credit watch, injector, freeze
# ---------------------------------------------------------------------------

def test_heartbeat_observe_declares_silent_chip_dead():
    hc = rsl.HealthConfig(n_chips=4, credit_timeout=2)
    jhc = jrsl.HealthConfig(n_chips=4, credit_timeout=2)
    st, jst = rsl.health_init(hc, device="cpu"), jrsl.health_init(jhc)
    truth = rsl.FabricFaultInjector(n_chips=4, chip_failures=((1, 3),))
    jtruth = jrsl.FabricFaultInjector(n_chips=4, chip_failures=((1, 3),))
    declared_at = None
    for t in range(10):
        st = rsl.observe(hc, st, rsl.beats_local(truth.alive_at(t)), t)
        jst = jrsl.observe(jhc, jst, jrsl.beats_local(jtruth.alive_at(t)), t)
        for f in rsl.HealthState._fields:
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(jst, f)))
        if declared_at is None and not bool(st.alive[1]):
            declared_at = t
    # silent from step 3, last heard at 2, declared when t - 2 > 2
    assert declared_at == 5
    assert st.alive.tolist() == [True, False, True, True]
    st2 = rsl.observe(hc, st, torch.ones(4, dtype=torch.int32),
                      torch.tensor(20))
    assert not bool(st2.alive[1])          # sticky-false


def test_heartbeat_psum_needs_the_multi_gpu_transport():
    with pytest.raises(NotImplementedError, match="item 7"):
        rsl.heartbeat(None, torch.ones(()))


def test_credit_watch_suspects_stalled_outstanding_chip():
    """A chip with packets outstanding whose notification counter stops
    is suspected after the timeout; an idle chip never is."""
    hc = rsl.HealthConfig(n_chips=3, credit_timeout=2)
    w = rsl.credit_watch_init(hc, device="cpu")
    jw = jrsl.credit_watch_init(jrsl.HealthConfig(n_chips=3,
                                                  credit_timeout=2))
    suspected = jsus = None
    for t in range(8):
        # chip 0: progressing; chip 1: outstanding + frozen; chip 2: idle
        vals = ([4, 4, 0], [1, 1, 0], [t, 1, 0], [8, 8, 8])
        flow = fc.RingState(*(torch.tensor(v, dtype=torch.int32)
                              for v in vals))
        jflow = jfc.RingState(*(jnp.asarray(v, jnp.int32) for v in vals))
        w, suspected = rsl.credit_watch(hc, w, flow, t)
        jw, jsus = jrsl.credit_watch(jrsl.HealthConfig(3, 2), jw, jflow, t)
        for f in rsl.CreditWatch._fields:
            np.testing.assert_array_equal(getattr(w, f).numpy(),
                                          np.asarray(getattr(jw, f)))
    assert suspected.tolist() == [False, True, False] == \
        np.asarray(jsus).tolist()


def test_fault_injector_masks_and_statics():
    inj = rsl.FabricFaultInjector(n_chips=4, chip_failures=((2, 5),),
                                  link_failures=((1, 0, 7),))
    assert inj.alive_at(4).tolist() == [True, True, True, True]
    assert inj.alive_at(5).tolist() == [True, True, False, True]
    assert inj.alive_at(torch.tensor(5)).tolist() == \
        [True, True, False, True]
    assert inj.alive_at(torch.tensor(4, dtype=torch.int32)).tolist() == \
        [True] * 4
    assert inj.healthy_after(4) == (0, 1, 2, 3)
    assert inj.healthy_after(5) == (0, 1, 3)
    assert inj.dead_links_after(6) == ()
    assert inj.dead_links_after(7) == ((1, 0),)
    with pytest.raises(ValueError, match="out of range"):
        rsl.FabricFaultInjector(n_chips=2, chip_failures=((5, 0),))


def test_mask_events_and_freeze():
    """``mask_events`` silences dead chips' events, ``freeze`` keeps their
    rows of every leaf; both equal JAX's."""
    inj = rsl.FabricFaultInjector(n_chips=3, chip_failures=((1, 2),))
    jinj = jrsl.FabricFaultInjector(n_chips=3, chip_failures=((1, 2),))
    spikes = np.random.default_rng(0).random((3, 8)) < 0.6
    bufs = ev.from_spikes(torch.from_numpy(spikes), 2, 8)[0]
    got = inj.mask_events(bufs, 2)
    assert not bool(got.valid[1].any())
    assert torch.equal(got.valid[0], bufs.valid[0])
    old = (torch.zeros((3, 4)), {"q": torch.arange(6).reshape(3, 2)})
    new = (torch.ones((3, 4)), {"q": -torch.arange(6).reshape(3, 2)})
    frozen = rsl.freeze(inj.alive_at(2), old, new)
    jfrozen = jrsl.freeze(jinj.alive_at(2),
                          jax.tree.map(lambda x: jnp.asarray(x.numpy()), old),
                          jax.tree.map(lambda x: jnp.asarray(x.numpy()), new))
    for a, b in zip(ckpt.tree_leaves(frozen), jax.tree.leaves(jfrozen)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert frozen[0][1].tolist() == [0.0] * 4


# ---------------------------------------------------------------------------
# The drills
# ---------------------------------------------------------------------------

N_DRILL, NN_DRILL, DEAD, KILL_AT, T_DRILL = 4, 16, 2, 7, 12
ALL = tuple(range(N_DRILL))
SURVIVORS = tuple(c for c in ALL if c != DEAD)


def _drill_comm(mod):
    return mod.PulseCommConfig(
        n_chips=N_DRILL, neurons_per_chip=NN_DRILL,
        n_inputs_per_chip=NN_DRILL, event_capacity=NN_DRILL,
        bucket_capacity=NN_DRILL, ring_depth=16)


def _ext_at(t):
    rng = np.random.default_rng(100 + t)
    return (1.5 * (rng.random((N_DRILL, NN_DRILL)) < 0.4)).astype(np.float32)


def _jax_drill(telemetry=None):
    jcfg = jnet.NetworkConfig(comm=_drill_comm(jpc),
                              topology=jtp.ring(N_DRILL, link_latency=0),
                              telemetry=telemetry)
    jparams = jnet.init_params(jax.random.PRNGKey(11), jcfg)
    return jcfg, jparams


def _port_drill(jcfg, jparams):
    tel = jcfg.telemetry
    cfg = net.NetworkConfig(
        comm=_drill_comm(pc),
        topology=convert.topology_from_jax(jcfg.topology),
        telemetry=None if tel is None else obs.MetricsConfig(
            **dataclasses.asdict(tel)))
    params = convert.params_from_jax(jparams, device="cpu")
    return cfg, params, net.init_state(cfg, params, device="cpu")


def _jax_make_step(jcfg, jparams, injector):
    """The reference drill's make_step, its network step jitted once per
    healthy set."""
    steps = {}

    def make_step(healthy):
        hcfg = dataclasses.replace(jcfg, healthy=tuple(healthy))
        if healthy not in steps:
            steps[healthy] = jax.jit(
                lambda s, e: jnet.step(hcfg, jparams, s, e))
        jstep = steps[healthy]

        def step_fn(state, t):
            alive = injector.alive_at(t)
            new_state, rec = jstep(state, jnp.asarray(_ext_at(t))
                                   * alive[:, None])
            fzn, fzr = jrsl.freeze(alive, (state.neuron, state.ring),
                                   (new_state.neuron, new_state.ring))
            new_state = new_state._replace(neuron=fzn, ring=fzr)
            return new_state, rec._replace(
                spikes=rec.spikes * alive[:, None].astype(rec.spikes.dtype))
        return step_fn

    return make_step


def make_drill_step(cfg, params, injector, ext_at, device=CPU):
    """The drill's ``(make_step, detect)`` on the port: the injector's
    masks emulate the death (dead chips stop emitting, their neuron and
    ring rows freeze); a rebuild's config runs degraded on the
    survivors."""
    def make_step(healthy):
        hcfg = dataclasses.replace(cfg, healthy=tuple(healthy))

        def step_fn(state, t):
            alive = injector.alive_at(t, device=device)
            ext = ext_at(t) * alive[:, None]
            new_state, rec = net.step(hcfg, params, state, ext,
                                      device=device)
            fzn, fzr = rsl.freeze(alive, (state.neuron, state.ring),
                                  (new_state.neuron, new_state.ring))
            new_state = new_state._replace(neuron=fzn, ring=fzr)
            return new_state, rec._replace(
                spikes=rec.spikes * alive[:, None].to(rec.spikes.dtype))
        return step_fn

    def detect(state, t, healthy):
        surviving = tuple(c for c in injector.healthy_after(t)
                          if c in healthy)
        return surviving if surviving != tuple(healthy) else None

    return make_step, detect


def _ext_port(t):
    return torch.from_numpy(_ext_at(t))


def _drill(tmp, failures, telemetry=None, **runner_kw):
    """The same drill in both packages; returns ``{"port": (runner,
    result or exception), "jax": ..., "cfg", "params", "state0"}``."""
    jcfg, jparams = _jax_drill(telemetry)
    cfg, params, state0 = _port_drill(jcfg, jparams)
    out = dict(cfg=cfg, params=params, state0=state0)
    for name in ("port", "jax"):
        if name == "port":
            inj = rsl.FabricFaultInjector(n_chips=N_DRILL,
                                          chip_failures=failures)
            make_step, detect = make_drill_step(cfg, params, inj, _ext_port)
            cls, init = ResilientRunner, state0
        else:
            inj = jrsl.FabricFaultInjector(n_chips=N_DRILL,
                                           chip_failures=failures)
            make_step = _jax_make_step(jcfg, jparams, inj)
            _, detect = make_drill_step(None, None, inj, None)
            cls, init = JResilientRunner, jnet.init_state(jcfg, jparams)
        flight = {}
        if telemetry is not None:
            (tmp / name).mkdir()
            flight = dict(flight_of=lambda s: s.metrics.flight,
                          flight_dir=str(tmp / name))
        runner = cls(make_step=make_step, detect=detect,
                     ckpt_dir=str(tmp / f"{name}_ckpt"), n_chips=N_DRILL,
                     **runner_kw, **flight)
        try:
            result = runner.run(init, T_DRILL)
        except Exception as e:  # the give-up drill's ChipFailure
            result = e
        out[name] = (runner, result)
    return out


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    return _drill(tmp_path_factory.mktemp("drill"), ((DEAD, KILL_AT),),
                  ckpt_every=3)


@pytest.fixture(scope="module")
def flight_drill(tmp_path_factory):
    return _drill(tmp_path_factory.mktemp("flight"), ((DEAD, KILL_AT),),
                  telemetry=jobs.MetricsConfig(flight_depth=4), ckpt_every=3)


def _same_records(got, want):
    assert sorted(got) == sorted(want)
    for t in sorted(want):
        np.testing.assert_array_equal(got[t].spikes.numpy(),
                                      np.asarray(want[t].spikes),
                                      err_msg=f"step {t}")
        np.testing.assert_allclose(got[t].voltage.numpy(),
                                   np.asarray(want[t].voltage), rtol=0,
                                   atol=1e-5, err_msg=f"step {t}")
        same_stats(want[t].stats, got[t].stats, msg=f"step {t}")


def _same_state(got, jwant):
    want = convert.state_from_jax(jwant, device="cpu")
    assert [f for f in got._fields if getattr(got, f) is None] == \
        [f for f in want._fields if getattr(want, f) is None]
    for name, (a, b) in enumerate(zip(ckpt.tree_leaves(got),
                                      ckpt.tree_leaves(want))):
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-5, err_msg=str(name))
        else:
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=str(name))


def test_resilient_runner_drill_matches_degraded_reference(drill):
    """Kill chip 2 at step 7: detected at 7, resumed from 6 (the newest
    checkpoint is step 5's) on the survivors; from the resume point the
    records equal an uninterrupted run on the survivors from the same
    checkpoint, bit for bit; dead-chip traffic is culled into
    ``lost_to_failure``."""
    runner, (final, healthy) = drill["port"]
    assert healthy == SURVIVORS
    assert runner.recoveries == [RecoveryEvent(
        detected_at=KILL_AT, resumed_from=6, healthy=healthy)]
    assert sorted(runner.records) == list(range(T_DRILL))

    resume_at = runner.recoveries[0].resumed_from
    ref_state = ckpt.restore(runner.ckpt_dir, resume_at - 1,
                             ckpt.tree_map(torch.zeros_like,
                                           drill["state0"]))
    inj = rsl.FabricFaultInjector(n_chips=N_DRILL,
                                  chip_failures=((DEAD, KILL_AT),))
    ref_step = make_drill_step(drill["cfg"], drill["params"], inj,
                               _ext_port)[0](healthy)
    spikes_ok = 0
    for t in range(resume_at, T_DRILL):
        ref_state, ref_rec = ref_step(ref_state, t)
        got = runner.records[t]
        assert torch.equal(got.spikes, ref_rec.spikes), t
        for f in pc.CommStats._fields:
            assert torch.equal(getattr(got.stats, f),
                               getattr(ref_rec.stats, f)), (t, f)
        if t >= KILL_AT:
            assert int(got.spikes[DEAD].sum()) == 0
        spikes_ok += int(got.spikes.sum())
    assert spikes_ok > 0
    for a, b in zip(ckpt.tree_leaves(final), ckpt.tree_leaves(ref_state)):
        assert torch.equal(a, b)
    lost = sum(int(runner.records[t].stats.lost_to_failure.sum())
               for t in range(resume_at, T_DRILL))
    assert lost > 0


def test_drill_equals_jax(drill):
    """Records, recoveries and the final state equal the JAX drill's."""
    runner, (final, healthy) = drill["port"]
    jrunner, (jfinal, jhealthy) = drill["jax"]
    assert healthy == tuple(jhealthy)
    assert [tuple(r) for r in runner.recoveries] == \
        [tuple(r) for r in jrunner.recoveries]
    _same_records(runner.records, jrunner.records)
    _same_state(final, jfinal)


def test_flight_recorder_dumps_on_chip_failure(flight_drill):
    """The ChipFailure path dumps the flight ring: its last K blocks are
    the per-step stats the failing trajectory recorded (steps 4..7), plus
    the failure row, and the run still recovers and finishes."""
    k = 4
    runner, (final, healthy) = flight_drill["port"]
    assert healthy == SURVIVORS
    assert len(runner.flight_dumps) == 1
    dump = obs.load_flight(runner.flight_dumps[0])
    assert dump["meta"]["depth"] == k
    assert dump["meta"]["n_chips"] == N_DRILL
    assert dump["failure"]["step"] == KILL_AT
    blocks = dump["blocks"]
    assert [b["seq"] for b in blocks] == list(range(KILL_AT - k + 1,
                                                    KILL_AT + 1))

    inj = rsl.FabricFaultInjector(n_chips=N_DRILL,
                                  chip_failures=((DEAD, KILL_AT),))
    ref_step = make_drill_step(flight_drill["cfg"], flight_drill["params"],
                               inj, _ext_port)[0](ALL)
    state, ref_stats = flight_drill["state0"], {}
    for t in range(KILL_AT + 1):
        state, rec = ref_step(state, t)
        ref_stats[t] = rec.stats
    for b in blocks:
        for fld in ("sent", "overflow", "expired", "stalled",
                    "lost_to_failure"):
            assert b["per_chip"][fld] == getattr(
                ref_stats[b["seq"]], fld).tolist(), (b["seq"], fld)
        for fld, fleet in b["fleet"].items():
            assert fleet == sum(b["per_chip"][fld]), (b["seq"], fld)


def test_flight_drill_equals_jax(flight_drill):
    """The telemetry drill in both packages: the same recoveries and
    records, dumps equal row for row, final states (the carry included:
    integers bitwise, EMAs within 1e-6) equal."""
    runner, (final, _) = flight_drill["port"]
    jrunner, (jfinal, _) = flight_drill["jax"]
    assert [tuple(r) for r in runner.recoveries] == \
        [tuple(r) for r in jrunner.recoveries]
    _same_records(runner.records, jrunner.records)
    assert len(runner.flight_dumps) == len(jrunner.flight_dumps) == 1
    for p, j in zip(runner.flight_dumps, jrunner.flight_dumps):
        assert obs.load_flight(p) == jobs.load_flight(j)
        assert open(p).read() == open(j).read()
    _same_state(final, jfinal)


def test_resilient_runner_gives_up_after_max_recoveries(tmp_path):
    out = _drill(tmp_path, ((0, 1), (1, 2), (2, 3)), ckpt_every=100,
                 max_recoveries=1)
    (runner, err), (jrunner, jerr) = out["port"], out["jax"]
    assert isinstance(err, ChipFailure)
    assert type(jerr).__name__ == "ChipFailure"
    assert (err.step, err.surviving) == (jerr.step, jerr.surviving)
    assert len(runner.recoveries) == 1
    assert [tuple(r) for r in runner.recoveries] == \
        [tuple(r) for r in jrunner.recoveries]
