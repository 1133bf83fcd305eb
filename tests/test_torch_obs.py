"""Port parity, telemetry (``repro_torch.obs``): the cases of
tests/test_obs.py on the port, and the port against the JAX package on
the CPU from the same parameters and inputs (numpy, seeded).

* Telemetry on against off: spikes, voltages, rings and every stat
  bitwise, on the superstep and the pipelined schedules.
* The carry after a run equals JAX's: every int32 field bitwise (totals,
  per-chip totals, maxima, histograms, link counters, the flight ring),
  every float32 EMA within 1e-6 relative (the closed-form fold sums in
  another order; ``pow`` may differ in the last bit).
* ``metrics_update`` on its own against JAX's, int32 wrap included.
* The exporters give the same strings as JAX's for the same dict, and
  each package's ``load_flight`` / monitor reads the other's dumps.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core import pulse_comm as jpc  # noqa: E402
from repro.core import topology as jtp  # noqa: E402
from repro.launch import monitor as jmonitor  # noqa: E402
from repro.runtime import ChipFailure as JChipFailure  # noqa: E402
from repro.runtime import RecoveryEvent as JRecoveryEvent  # noqa: E402
from repro.snn import network as jnet  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.core import pulse_comm as pc  # noqa: E402
from repro_torch.launch import monitor  # noqa: E402
from repro_torch.obs import metrics as obm  # noqa: E402
from repro_torch.runtime import ChipFailure, RecoveryEvent  # noqa: E402
from repro_torch.snn import network as net  # noqa: E402

EMA_RTOL = 1e-6


# ---------------------------------------------------------------------------
# Networks in both packages from the same parameters
# ---------------------------------------------------------------------------

def _nets(telemetry=None, pipeline=False, superstep=4, n_chips=4, nn=16,
          ring=False):
    """The reference test's network, in JAX and (from the same params) in
    the port: ``(jcfg, jparams, cfg, params)``."""
    kw = dict(n_chips=n_chips, neurons_per_chip=nn, n_inputs_per_chip=nn,
              event_capacity=nn, bucket_capacity=nn, ring_depth=16,
              superstep=superstep)
    jtopo = jtp.ring(n_chips, link_latency=1) if (ring or pipeline) else None
    jcfg = jnet.NetworkConfig(comm=jpc.PulseCommConfig(**kw), topology=jtopo,
                              pipeline=pipeline, telemetry=telemetry)
    jparams = jnet.init_params(jax.random.PRNGKey(3), jcfg)
    ptel = (obs.MetricsConfig(**dataclasses.asdict(telemetry))
            if isinstance(telemetry, jobs.MetricsConfig) else telemetry)
    cfg = net.NetworkConfig(
        comm=pc.PulseCommConfig(**kw), pipeline=pipeline, telemetry=ptel,
        topology=None if jtopo is None else convert.topology_from_jax(jtopo))
    return jcfg, jparams, cfg, convert.params_from_jax(jparams, device="cpu")


def _ext(cfg, t, seed=7):
    c = cfg.comm
    rng = np.random.default_rng(seed)
    return (1.5 * (rng.random((t, c.n_chips, c.n_inputs_per_chip)) < 0.35)
            ).astype(np.float32)


def _run_port(cfg, params, ext):
    return net.run(cfg, params, net.init_state(cfg, params, device="cpu"),
                   torch.from_numpy(ext), device="cpu")


def _run_jax(jcfg, jparams, ext):
    return jnet.run(jcfg, jparams, jnet.init_state(jcfg, jparams),
                    jnp.asarray(ext))


def assert_carry_equal(got, want):
    """A port carry (``MetricsCarry`` of tensors) against a JAX one:
    integers bitwise, floats within ``EMA_RTOL`` relative."""
    gl = ckpt.tree_leaves(got)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    names = list(obm.MetricsCarry._fields[:-1]) + [
        "flight." + f for f in obm.FlightRing._fields]
    for name, g, w in zip(names, gl, wl):
        g, w = g.cpu().numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=EMA_RTOL, atol=1e-30,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module", params=[False, True],
                ids=["superstep", "pipelined"])
def runs(request):
    """T 16 on both schedules: the port with telemetry off and on, JAX
    with it on."""
    pipeline = request.param
    t = 16
    jcfg, jparams, cfg_on, params = _nets(True, pipeline=pipeline)
    cfg_off = dataclasses.replace(cfg_on, telemetry=None)
    ext = _ext(cfg_on, t)
    return dict(pipeline=pipeline, t=t, cfg=cfg_on,
                off=_run_port(cfg_off, params, ext),
                on=_run_port(cfg_on, params, ext),
                jax=_run_jax(jcfg, jparams, ext))


# ---------------------------------------------------------------------------
# Network-threaded telemetry
# ---------------------------------------------------------------------------

def test_telemetry_bitwise_invariant(runs):
    """Telemetry on against off: identical spikes, voltages, stats and
    final rings; the carry aggregates every substep."""
    (f_off, r_off), (f_on, r_on) = runs["off"], runs["on"]
    assert torch.equal(r_off.spikes, r_on.spikes)
    assert torch.equal(r_off.voltage, r_on.voltage)
    assert torch.equal(f_off.ring.ring, f_on.ring.ring)
    for f in pc.CommStats._fields:
        assert torch.equal(getattr(r_off.stats, f), getattr(r_on.stats, f))
    assert f_off.metrics is None
    m = f_on.metrics
    b = runs["cfg"].comm.superstep
    # the pipelined run folds one extra all-zero prologue block in
    assert int(m.steps) == runs["t"] + (b if runs["pipeline"] else 0)
    sent = int(r_on.stats.sent.sum())
    assert int(m.totals[obm.SCALAR_FIELDS.index("sent")]) == sent > 0


def test_carry_equals_jax(runs):
    """The port's carry after the run equals JAX's, and so do spikes and
    the summary's integers."""
    (f_on, r_on), (jf, jr) = runs["on"], runs["jax"]
    np.testing.assert_array_equal(r_on.spikes.numpy(), np.asarray(jr.spikes))
    assert_carry_equal(f_on.metrics, jf.metrics)
    got = obs.metrics_summary(f_on.metrics)
    want = jobs.metrics_summary(jf.metrics)
    for key in ("steps", "blocks", "totals", "max", "hist", "chip_totals"):
        assert got[key] == want[key], key
    assert got["link"]["words"] == want["link"]["words"]


def test_metrics_match_offline_reduction():
    """The carry's aggregates equal an offline reduction of the recorded
    per-step CommStats, and the whole summary equals JAX's."""
    t = 24
    jcfg, jparams, cfg, params = _nets(True, ring=True)
    mcfg = net._metrics_cfg(cfg)
    ext = _ext(cfg, t)
    final, recs = _run_port(cfg, params, ext)
    s = obs.metrics_summary(final.metrics, mcfg)
    assert s["steps"] == t
    edges = np.asarray(obm.HIST_EDGES)
    a = mcfg.ema_alpha
    for fld in obm.SCALAR_FIELDS:
        arr = getattr(recs.stats, fld).numpy().reshape(t, -1)
        fleet = arr.sum(1)
        assert s["totals"][fld] == fleet.sum(), fld
        assert s["max"][fld] == fleet.max(), fld
        assert s["chip_totals"][fld] == arr.sum(0).tolist(), fld
        bucket = (fleet[:, None] >= edges[None, :]).sum(1)
        want_hist = np.bincount(bucket, minlength=obm.N_BUCKETS)
        assert s["hist"][fld] == want_hist.tolist(), fld
        ema = 0.0
        for x in fleet:
            ema = a * ema + (1 - a) * float(x)
        np.testing.assert_allclose(s["ema"][fld], ema, rtol=1e-4,
                                   atol=1e-4, err_msg=fld)
    assert np.asarray(s["link"]["words"]).sum() == \
        recs.stats.link_words.sum()

    jfinal, _ = _run_jax(jcfg, jparams, ext)
    assert_carry_equal(final.metrics, jfinal.metrics)


def test_metrics_ride_checkpoint_roundtrip(tmp_path):
    """The carry is ordinary state: it survives save and restore, and two
    half runs aggregate exactly like one full run."""
    t = 16
    _, _, cfg, params = _nets(True)
    ext = torch.from_numpy(_ext(cfg, t))
    state = net.init_state(cfg, params, device="cpu")
    full, _ = net.run(cfg, params, state, ext, device="cpu")
    half, _ = net.run(cfg, params, state, ext[: t // 2], device="cpu")
    ckpt.save(half, str(tmp_path), 0)
    restored = ckpt.restore(str(tmp_path), 0,
                            ckpt.tree_map(torch.zeros_like, half))
    resumed, _ = net.run(cfg, params, restored, ext[t // 2:], device="cpu")
    for a, b in zip(ckpt.tree_leaves(full.metrics),
                    ckpt.tree_leaves(resumed.metrics)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_state_from_jax_carries_the_metrics():
    """``convert.state_from_jax`` carries a JAX telemetry carry, and a run
    continued from it in the port equals JAX's continuation."""
    t = 8
    jcfg, jparams, cfg, params = _nets(True, ring=True)
    ext = _ext(cfg, 2 * t)
    jmid, _ = _run_jax(jcfg, jparams, ext[:t])
    mid = convert.state_from_jax(jmid, device="cpu")
    assert_carry_equal(mid.metrics, jmid.metrics)
    got, _ = net.run(cfg, params, mid, torch.from_numpy(ext[t:]),
                     device="cpu")
    want, _ = jnet.run(jcfg, jparams, jmid, jnp.asarray(ext[t:]))
    assert_carry_equal(got.metrics, want.metrics)


def test_dense_path_folds_nothing():
    _, _, cfg, params = _nets(True, superstep=1)
    cfg = dataclasses.replace(cfg, comm_mode="dense")
    state = net.init_state(cfg, net.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu"), device="cpu")
    final, _ = net.run(cfg, params, state, torch.ones((4, 4, 16)),
                       device="cpu")
    assert int(final.metrics.blocks) == 0 and int(final.metrics.steps) == 0


# ---------------------------------------------------------------------------
# metrics_update alone, against JAX's
# ---------------------------------------------------------------------------

def _fake(rng, b, n_chips, n_ports, big=False):
    """Random CommStats-like fields, per step (b None) or per block."""
    lead = () if b is None else (b,)
    hi = 2**30 if big else 100
    ints = {f: rng.integers(0, hi, lead + (n_chips,)).astype(np.int32)
            for f in obm.SCALAR_FIELDS}
    ints["link_words"] = rng.integers(0, 50, lead + (n_chips, n_ports)
                                      ).astype(np.int32)
    ints["link_backlog"] = rng.integers(0, 9, lead + (n_chips, n_ports)
                                        ).astype(np.int32)
    util = rng.random(lead + (n_chips,)).astype(np.float32)
    port = types.SimpleNamespace(utilization=torch.from_numpy(util), **{
        k: torch.from_numpy(v) for k, v in ints.items()})
    jx = types.SimpleNamespace(utilization=jnp.asarray(util), **{
        k: jnp.asarray(v) for k, v in ints.items()})
    return port, jx


def _occ(rng, n_chips):
    per_chip = rng.integers(0, 40, n_chips).astype(np.int32)
    return (types.SimpleNamespace(occupancy=lambda: torch.from_numpy(
                per_chip)),
            types.SimpleNamespace(occupancy=lambda: jnp.asarray(
                per_chip.sum(), jnp.int32)))


@pytest.mark.parametrize("b,big", [(None, False), (3, False), (2, True)],
                         ids=["per-step", "block", "int32-wrap"])
def test_metrics_update_equals_jax(b, big):
    """Seven updates (the ring of depth 3 wraps), with merge and pending
    occupancies and a link capacity: every field against JAX's."""
    rng = np.random.default_rng(11)
    n_chips, n_ports = 3, 2
    mcfg = obs.MetricsConfig(flight_depth=3, link_capacity=4, ema_alpha=0.8)
    jmcfg = jobs.MetricsConfig(flight_depth=3, link_capacity=4,
                               ema_alpha=0.8)
    m = obs.metrics_init(mcfg, n_chips, n_ports, device="cpu")
    jm = jobs.metrics_init(jmcfg, n_chips, n_ports)
    for _ in range(7):
        stats, jstats = _fake(rng, b, n_chips, n_ports, big)
        merge, jmerge = _occ(rng, n_chips)
        pend, jpend = _occ(rng, n_chips)
        m = obs.metrics_update(mcfg, m, stats, merge=merge, pending=pend)
        jm = jobs.metrics_update(jmcfg, jm, jstats, merge=jmerge,
                                 pending=jpend)
    assert_carry_equal(m, jm)
    if big:
        assert int(m.totals[0]) < 0     # wrapped as int32, as in JAX


# ---------------------------------------------------------------------------
# check_conservation
# ---------------------------------------------------------------------------

def test_check_conservation_closes():
    rep = obs.check_conservation(
        {"sent": 10, "overflow": 2, "expired": 1}, delivered=5, queued=2)
    assert rep.ok and rep.residual == 0
    assert rep.legs["overflow"] == 2
    assert "injected" in rep.render()


def test_check_conservation_strict_raises_with_breakdown():
    with pytest.raises(AssertionError, match="overflow"):
        obs.check_conservation({"sent": 10, "overflow": 2}, delivered=5)
    rep = obs.check_conservation({"sent": 10, "overflow": 2}, delivered=5,
                                 strict=False)
    assert not rep.ok and rep.residual == 3


def test_check_conservation_sums_arrays_and_extras():
    stats = {"sent": torch.tensor([4, 6]), "overflow": np.array([[1], [1]])}
    assert obs.check_conservation(stats, delivered=torch.tensor(7),
                                  queued=1).ok
    rep = obs.check_conservation({"sent": 5}, delivered=3, in_flight=1,
                                 extra_injected=2, extra_accounted=3)
    assert rep.ok
    assert rep.render() == jobs.check_conservation(
        {"sent": 5}, delivered=3, in_flight=1, extra_injected=2,
        extra_accounted=3).render()


# ---------------------------------------------------------------------------
# Flight ring
# ---------------------------------------------------------------------------

def _fake_stats(n_chips, sent, backlog=0):
    z = torch.zeros((n_chips,), dtype=torch.int32)
    return types.SimpleNamespace(
        sent=torch.full((n_chips,), sent, dtype=torch.int32),
        overflow=z, merge_dropped=z, expired=z, stalled=z,
        wire_bytes=z, lost_to_failure=z,
        utilization=torch.zeros((n_chips,)),
        link_words=torch.full((n_chips, 1), sent, dtype=torch.int32),
        link_backlog=torch.full((n_chips, 1), backlog, dtype=torch.int32))


def _ring(depth, n_blocks, n_chips=2):
    mcfg = obs.MetricsConfig(flight_depth=depth)
    m = obs.metrics_init(mcfg, n_chips, device="cpu")
    for b in range(n_blocks):
        m = obs.metrics_update(mcfg, m, _fake_stats(n_chips, b + 1))
    return m


def test_flight_ring_keeps_last_k_blocks():
    rows = obs.flight_rows(_ring(3, 7).flight)
    assert [r["seq"] for r in rows] == [4, 5, 6]
    assert [r["t0"] for r in rows] == [4, 5, 6]
    assert [r["fleet"]["sent"] for r in rows] == [10, 12, 14]
    assert rows[-1]["per_chip"]["sent"] == [7, 7]


def test_flight_ring_partial_fill():
    rows = obs.flight_rows(_ring(8, 1).flight)
    assert [r["seq"] for r in rows] == [0]
    assert rows[0]["fleet"]["sent"] == 2


def test_dump_flight_roundtrip(tmp_path):
    m = _ring(2, 3)
    path = str(tmp_path / "flight.jsonl")
    obs.dump_flight(path, m.flight,
                    recoveries=[RecoveryEvent(detected_at=1, resumed_from=0,
                                              healthy=(0,))],
                    failure=ChipFailure(2, (0,)), meta={"extra": 1})
    dump = obs.load_flight(path)
    assert dump["meta"]["depth"] == 2 and dump["meta"]["extra"] == 1
    assert [b["seq"] for b in dump["blocks"]] == [1, 2]
    assert dump["recoveries"][0]["detected_at"] == 1
    assert dump["failure"]["step"] == 2
    assert dump["failure"]["surviving"] == [0]


def test_flight_dumps_cross_the_two_packages(tmp_path):
    """The same ring through either package's ``dump_flight``: identical
    files, each read by the other's ``load_flight`` and monitor check."""
    m = _ring(3, 5)
    jmcfg = jobs.MetricsConfig(flight_depth=3)
    jm = jobs.metrics_init(jmcfg, 2)
    for b in range(5):
        z = jnp.zeros((2,), jnp.int32)
        jm = jobs.metrics_update(jmcfg, jm, types.SimpleNamespace(
            sent=jnp.full((2,), b + 1, jnp.int32), overflow=z,
            merge_dropped=z, expired=z, stalled=z, wire_bytes=z,
            lost_to_failure=z, utilization=jnp.zeros((2,)),
            link_words=jnp.full((2, 1), b + 1, jnp.int32),
            link_backlog=jnp.zeros((2, 1), jnp.int32)))
    port, jpath = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    obs.dump_flight(port, m.flight,
                    recoveries=[RecoveryEvent(3, 2, (0, 1))],
                    failure=ChipFailure(4, (1,)))
    jobs.dump_flight(jpath, jm.flight,
                     recoveries=[JRecoveryEvent(3, 2, (0, 1))],
                     failure=JChipFailure(4, (1,)))
    assert open(port).read() == open(jpath).read()
    assert jobs.load_flight(port) == obs.load_flight(jpath) \
        == obs.load_flight(port)
    assert jmonitor.check_dump(port) == 0 and monitor.check_dump(jpath) == 0


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def test_jsonl_roundtrip_and_logger(tmp_path):
    p = str(tmp_path / "rows.jsonl")
    rows = [{"kind": "meta", "a": 1}, {"kind": "x", "b": [1, 2]}]
    obs.write_jsonl(p, rows)
    assert list(obs.read_jsonl(p)) == rows
    with obs.JsonlLogger(p) as log:        # append mode
        log.emit("evt", n=3)
    assert list(obs.read_jsonl(p)) == rows + [{"kind": "evt", "n": 3}]
    assert list(jobs.read_jsonl(p)) == list(obs.read_jsonl(p))


def test_prometheus_text_format():
    metrics = {"a": 1, "b": 2.5, "skip": "str", "flag": True,
               "odd name/x": 0.125}
    txt = obs.prometheus_text(metrics, prefix="t", labels={"arch": "x",
                                                           "b-y": "2"})
    assert '# TYPE t_a gauge' in txt
    assert 't_a{arch="x",b_y="2"} 1' in txt
    assert 't_b{arch="x",b_y="2"} 2.5' in txt
    assert "skip" not in txt and "flag" not in txt
    assert txt == jobs.prometheus_text(metrics, prefix="t",
                                       labels={"arch": "x", "b-y": "2"})


def test_summary_exposition_covers_fields():
    _, _, cfg, params = _nets(True, superstep=1)
    final, _ = _run_port(cfg, params, _ext(cfg, 8))
    summary = obs.metrics_summary(final.metrics)
    txt = obs.summary_exposition(summary)
    for fld in obm.SCALAR_FIELDS:
        assert f"repro_fabric_{fld}_total" in txt
        assert f"repro_fabric_{fld}_per_step_ema" in txt
    assert "repro_fabric_steps_total 8" in txt
    assert txt == jobs.summary_exposition(summary)
    assert obs.summary_exposition(summary, labels={"run": "a"}) == \
        jobs.summary_exposition(summary, labels={"run": "a"})


# ---------------------------------------------------------------------------
# Monitor CLI smoke
# ---------------------------------------------------------------------------

def test_monitor_demo_and_check(tmp_path, capsys):
    path = str(tmp_path / "dump.jsonl")
    res = monitor.demo(steps=16, n_chips=2, superstep=4, n_neurons=16,
                       jsonl=path, device="cpu")
    assert res["report"].ok and res["summary"]["totals"]["sent"] > 0
    assert monitor.check_dump(path) == 0
    assert jmonitor.check_dump(path) == 0
    monitor.render_dump(path)
    out = capsys.readouterr().out
    assert "conservation identity" in out
    assert "drop buckets" in out
    assert monitor.main(["--demo", "--device", "cpu", "--steps", "8",
                         "--chips", "2", "--neurons", "16", "--jsonl",
                         str(tmp_path / "cli.jsonl"), "--check"]) == 0
    assert monitor.main(["--dump", path]) == 0
