"""Port parity, pipelined schedule: ``PulseFabric.pipeline_block`` /
``flush_pending`` / ``run_pipelined`` and ``NetworkConfig(pipeline=True)``
of ``repro_torch`` against the JAX fabric and network (``transport=
"local"``, unfused chain) on the CPU, from inputs made with numpy.

Tolerances: every integer output (delay ring and clock, delivered words,
merge and send queues, credit counters, the in-flight carry and every
integer ``CommStats`` field) bitwise; ``utilization`` (an f32 mean)
within 1 f32 ulp.  Also held, in the port alone: pipelined ≡ serial where
every delay exceeds the two-block wait (2B - 1), streaming ≡
``run_pipelined``, conservation with the in-flight leg, a straggler that
expires with accounting, and the guards.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import delays as jdl  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import fabric as jfb  # noqa: E402
from repro.core import pulse_comm as jpc  # noqa: E402
from repro.core import routing as jrt  # noqa: E402
from repro.snn import network as jnet  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import delays as dl  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import fabric as fb  # noqa: E402
from repro_torch.core import pulse_comm as pc  # noqa: E402
from repro_torch.core import routing as rt  # noqa: E402
from repro_torch.snn import network as net  # noqa: E402

N_CHIPS, N, T0 = 4, 32, 250


def same(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=msg)


def same_stats(want, got, msg=""):
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f == "utilization":
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            np.testing.assert_array_equal(w, g, err_msg=f"{msg} {f}")


def same_pending(jp, p, msg=""):
    """The JAX carry is batched chip-first; the port's block stats lead
    with the substep axis."""
    same(jp.words, p.words, f"{msg} words")
    same(jp.t0, p.t0, f"{msg} t0")
    same(jp.valid, p.valid, f"{msg} valid")
    same(jp.link.words, p.link.words, f"{msg} link")
    for f in jp.inject._fields:
        w = np.swapaxes(np.asarray(getattr(jp.inject, f)), 0, 1)
        g = getattr(p.inject, f).numpy()
        if f == "utilization":
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            np.testing.assert_array_equal(w, g, err_msg=f"{msg} {f}")


def _setup(b, *, mode="simplified", rate=0, depth=8, f=4, seed=0,
           min_delay=8, max_delay=12, ring_depth=16, fanout=1, cap=6,
           p=0.4):
    """Both configs, the LUT (JAX and port) and ``f`` blocks of events
    ``[F, B, n_chips, E]`` (numpy), clocks from ``T0`` across the 8-bit
    wrap."""
    kw = dict(n_chips=N_CHIPS, neurons_per_chip=N, n_inputs_per_chip=N,
              event_capacity=N, fanout=fanout, bucket_capacity=cap,
              buckets_per_chip=2, ring_depth=ring_depth, mode=mode,
              merge_rate=rate, merge_depth=depth, superstep=b)
    rng = np.random.default_rng(seed)
    shape = (N_CHIPS, N, fanout)
    table = rt.RoutingTable(
        dest_chip=torch.as_tensor(rng.integers(0, N_CHIPS, shape),
                                  dtype=torch.int32),
        dest_addr=torch.as_tensor(rng.integers(0, N, shape),
                                  dtype=torch.int32),
        delay=torch.as_tensor(rng.integers(min_delay, max_delay + 1, shape),
                              dtype=torch.int32),
        valid=torch.as_tensor(rng.random(shape) < 0.95))
    jtable = jrt.RoutingTable(*(jnp.asarray(x.numpy()) for x in table))
    spikes = torch.as_tensor(rng.random((f * b, N_CHIPS, N)) < p)
    bufs = [ev.from_spikes(spikes[t], T0 + t, N)[0] for t in range(f * b)]
    events = ev.EventBuffer(*(torch.stack(x).reshape((f, b) + x[0].shape)
                              for x in zip(*bufs)))
    return jpc.PulseCommConfig(**kw), pc.PulseCommConfig(**kw), jtable, \
        table, events


def _jax_events(events):
    return jev.EventBuffer(*(jnp.asarray(x.numpy()) for x in events))


def _rings(cfg):
    jring = jax.vmap(lambda _: jdl.init(cfg.ring_depth, N, now=T0))(
        jnp.arange(N_CHIPS))
    return jring, dl.init(cfg.ring_depth, N, now=T0,
                          batch_shape=(N_CHIPS,))


def _jax_flow(flow):
    return None if flow is None else jfb.FlowControlConfig(
        **dataclasses.asdict(flow))


def _both(jcfg, cfg, flow=None):
    return (jfb.PulseFabric(jcfg, transport="local", flow=_jax_flow(flow)),
            fb.PulseFabric(cfg, device="cpu", flow=flow))


def _serial(fab, events, table, ring):
    """F serial supersteps; returns (ring, delivered[F], stats[F])."""
    b = fab.cfg.superstep
    merge, dels, stats = None, [], []
    for f in range(events.addr.shape[0]):
        res = fab.superstep(ev.EventBuffer(*(x[f] for x in events)), table,
                            ring, None, merge)
        merge = res.merge
        ring = dl.DelayRing(ring=res.ring.ring, now=res.ring.now + b)
        dels.append(res.delivered.words)
        stats.append(res.stats)
    return ring, torch.stack(dels), pc.CommStats(
        *(torch.stack(x) for x in zip(*stats)))


def _totals(stats):
    g = lambda f: int(getattr(stats, f).sum())  # noqa: E731
    return g("sent"), (g("overflow") + g("expired") + g("stalled")
                       + g("merge_dropped") + g("lost_to_failure"))


@pytest.mark.parametrize("mode,rate,depth,min_delay", [
    ("simplified", 0, 8, 8), ("full", 0, 8, 8),
    # the merge queue's wait erodes slack: depth <= 2 * rate bounds it
    # below min_delay - (2B - 1)
    ("full", 3, 6, 10)])
@pytest.mark.parametrize("b", [1, 2, 4])
def test_run_pipelined_matches_jax_and_serial(b, mode, rate, depth,
                                              min_delay):
    jcfg, cfg, jtable, table, events = _setup(
        b, mode=mode, rate=rate, depth=depth, min_delay=min_delay,
        max_delay=min_delay + 4, ring_depth=20)
    jfab, fab = _both(jcfg, cfg)
    jring, ring = _rings(cfg)
    jres = jax.jit(jfab.run_pipelined)(_jax_events(events), jtable, jring)
    res = fab.run_pipelined(events, table, ring)
    same(jres.ring.ring, res.ring.ring, "ring")
    same(jres.ring.now, res.ring.now, "clock")
    same(jres.delivered.words, res.delivered.words, "words")
    same_stats(jres.stats, res.stats, "stats")
    if rate:
        same(jres.merge.words, res.merge.words, "merge queue")
    assert int(res.pending.occupancy().sum()) == 0
    assert not bool(res.pending.valid.any())
    ring_s, words_s, stats_s = _serial(fab, events, table, ring)
    assert torch.equal(ring_s.ring, res.ring.ring)
    assert torch.equal(ring_s.now, res.ring.now)
    assert torch.equal(words_s, res.delivered.words)
    for f in pc.CommStats._fields:
        assert torch.equal(getattr(stats_s, f), getattr(res.stats, f)), f
    assert int(res.stats.sent.sum()) > 0
    if rate:
        assert int(res.stats.merge_dropped.sum()) > 0


def test_pipeline_blocks_and_carry_match_jax_block_by_block():
    """The streaming form against JAX's, block by block: delivered words,
    stats, ring and the carry itself (words, link, the carried block's
    stats, t0, valid), through the prologue and the flush."""
    b = 2
    jcfg, cfg, jtable, table, events = _setup(b, mode="full", rate=3,
                                              depth=6, min_delay=6)
    jfab, fab = _both(jcfg, cfg)
    jring, ring = _rings(cfg)
    jstep = jax.jit(jfab.pipeline_block)
    jmerge, merge = jfab.init_merge(), fab.init_merge()
    jpend, pend = jfab.init_pending(), fab.init_pending()
    same_pending(jpend, pend, "empty carry")
    for f in range(events.addr.shape[0]):
        blk = ev.EventBuffer(*(x[f] for x in events))
        jres = jstep(_jax_events(blk), jtable, jring, None, jmerge, None,
                     jpend)
        res = fab.pipeline_block(blk, table, ring, None, merge, None, pend)
        where = f"block {f}"
        same(jres.ring.ring, res.ring.ring, f"ring {where}")
        same(jres.delivered.words, res.delivered.words, f"words {where}")
        same_stats(jres.stats, res.stats, where)
        same_pending(jres.pending, res.pending, where)
        same(jres.merge.words, res.merge.words, f"merge {where}")
        assert int(res.pending.occupancy().sum()) == int(
            np.asarray(jres.pending.occupancy()).sum())
        jring = jdl.DelayRing(jres.ring.ring, jres.ring.now + b)
        ring = dl.DelayRing(res.ring.ring, res.ring.now + b)
        jmerge, merge, jpend, pend = (jres.merge, res.merge, jres.pending,
                                      res.pending)
    jres = jax.jit(jfab.flush_pending)(jring, jpend, None, jmerge)
    res = fab.flush_pending(ring, pend, None, merge)
    same(jres.ring.ring, res.ring.ring, "ring after the flush")
    same(jres.delivered.words, res.delivered.words, "flushed words")
    same_stats(jres.stats, res.stats, "flush")
    same_pending(jres.pending, res.pending, "flushed carry")


def test_streaming_pipeline_blocks_match_run_pipelined():
    b = 4
    _, cfg, _, table, events = _setup(b)
    fab = fb.PulseFabric(cfg, device="cpu")
    _, ring0 = _rings(cfg)
    ref = fab.run_pipelined(events, table, ring0)
    ring, pending, dels, stats = ring0, fab.init_pending(), [], []
    for f in range(events.addr.shape[0]):
        res = fab.pipeline_block(ev.EventBuffer(*(x[f] for x in events)),
                                 table, ring, pending=pending)
        pending = res.pending
        ring = dl.DelayRing(ring=res.ring.ring, now=res.ring.now + b)
        dels.append(res.delivered.words)
        stats.append(res.stats)
    fres = fab.flush_pending(ring, pending)
    dels = dels[1:] + [fres.delivered.words]
    stats = stats[1:] + [fres.stats]
    assert torch.equal(ref.ring.ring, fres.ring.ring)
    assert torch.equal(ref.delivered.words, torch.stack(dels))
    for i, f in enumerate(pc.CommStats._fields):
        assert torch.equal(getattr(ref.stats, f),
                           torch.stack([s[i] for s in stats])), f
    assert int(fres.pending.occupancy().sum()) == 0


@pytest.mark.parametrize("mode,rate", [("simplified", 0), ("full", 3)])
def test_conservation_includes_in_flight_carry(mode, rate):
    """Mid-stream, every sent word is in a ring, a stats leg, the merge
    queue, or the in-flight carry (whose block's stats are not reported
    yet); after the flush the carry is empty and the identity closes
    without it."""
    b = 4
    _, cfg, _, table, events = _setup(b, mode=mode, rate=rate)
    fab = fb.PulseFabric(cfg, device="cpu")
    _, ring = _rings(cfg)
    merge, pending = fab.init_merge(), fab.init_pending()
    sent = acc = 0

    def closes(ring, merge, pending, extra_sent=0, extra_acc=0):
        queued = 0 if merge is None else int(merge.occupancy().sum())
        assert sent + extra_sent == (int(ring.ring.sum()) + acc + extra_acc
                                     + queued
                                     + int(pending.occupancy().sum()))

    for f in range(events.addr.shape[0]):
        res = fab.pipeline_block(ev.EventBuffer(*(x[f] for x in events)),
                                 table, ring, None, merge, None, pending)
        merge, pending = res.merge, res.pending
        ring = dl.DelayRing(ring=res.ring.ring, now=res.ring.now + b)
        s, a = _totals(res.stats)
        sent, acc = sent + s, acc + a
        inj = pending.inject
        assert int(pending.occupancy().sum()) > 0
        closes(ring, merge, pending, int(inj.sent.sum()),
               sum(int(getattr(inj, k).sum())
                   for k in ("overflow", "stalled", "wrap_expired", "lost")))
    fres = fab.flush_pending(ring, pending, None, merge)
    s, a = _totals(fres.stats)
    sent, acc = sent + s, acc + a
    assert int(fres.pending.occupancy().sum()) == 0
    closes(fres.ring, fres.merge, fres.pending)


def test_straggler_expires_with_accounting_never_ghosts():
    """Delays 5..6 <= 2B - 1 = 7: the serial schedule delivers them, the
    pipelined one expires them with accounting (as JAX does), never
    deposits into an already-popped slot."""
    b = 4
    jcfg, cfg, jtable, table, events = _setup(b, min_delay=5, max_delay=6)
    jfab, fab = _both(jcfg, cfg)
    jring, ring = _rings(cfg)
    res = fab.run_pipelined(events, table, ring)
    jres = jax.jit(jfab.run_pipelined)(_jax_events(events), jtable, jring)
    same(jres.ring.ring, res.ring.ring, "ring")
    same_stats(jres.stats, res.stats, "stats")
    ring_s, _, stats_s = _serial(fab, events, table, ring)
    ser_sent, ser_acc = _totals(stats_s)
    pip_sent, pip_acc = _totals(res.stats)
    dep_s, dep_p = int(ring_s.ring.sum()), int(res.ring.ring.sum())
    assert ser_sent == pip_sent == dep_s + ser_acc == dep_p + pip_acc
    assert dep_p < dep_s
    assert int(res.stats.expired.sum()) > int(stats_s.expired.sum())


def test_pipeline_guard_rejects_wrap_unsafe_config():
    cfg = pc.PulseCommConfig(n_chips=N_CHIPS, neurons_per_chip=16,
                             n_inputs_per_chip=16, event_capacity=16,
                             bucket_capacity=4, ring_depth=100, superstep=14)
    fab = fb.PulseFabric(cfg, device="cpu")
    buf = ev.from_spikes(torch.zeros((N_CHIPS, 16), dtype=torch.bool), 0,
                         16)[0]
    blk = ev.EventBuffer(*(x.expand((14,) + x.shape) for x in buf))
    table = rt.random_table(torch.Generator().manual_seed(0), 16, N_CHIPS)
    table = rt.RoutingTable(*(x.expand((N_CHIPS,) + x.shape) for x in table))
    rings = dl.init(100, 16, batch_shape=(N_CHIPS,))
    fab.superstep(blk, table, rings)     # 14 + 100 < 128 ...
    with pytest.raises(ValueError, match="wrap half-window"):
        fab.run_pipelined(ev.EventBuffer(*(x[None] for x in blk)), table,
                          rings)          # ... but 28 + 100 >= 128
    with pytest.raises(ValueError, match="wrap half-window"):
        fab.pipeline_block(blk, table, rings)


def test_network_config_rejects_pipelined_dense_mode():
    comm = pc.PulseCommConfig(n_chips=2, neurons_per_chip=8,
                              n_inputs_per_chip=8, event_capacity=8,
                              bucket_capacity=4, ring_depth=8)
    with pytest.raises(ValueError, match="dense"):
        net.NetworkConfig(comm=comm, comm_mode="dense", pipeline=True)


def test_network_step_rejects_pipelined_driving():
    comm = pc.PulseCommConfig(n_chips=2, neurons_per_chip=8,
                              n_inputs_per_chip=8, event_capacity=8,
                              bucket_capacity=4, ring_depth=8)
    cfg = net.NetworkConfig(comm=comm, pipeline=True)
    params = net.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    state = net.init_state(cfg, params, device="cpu")
    assert state.pending is not None and not bool(state.pending.valid.any())
    with pytest.raises(ValueError, match=r"run\(\)"):
        net.step(cfg, params, state, torch.zeros((2, 8)), device="cpu")


def _network(pipeline, flow=None, b=4, t=16, seed=0):
    """Both networks from the same weights (a dyadic grid, so crossbar
    sums are exact in any order), LUT (delays 9..14) and input."""
    comm_kw = dict(n_chips=N_CHIPS, neurons_per_chip=N, n_inputs_per_chip=N,
                   event_capacity=64, bucket_capacity=8, ring_depth=20,
                   superstep=b)
    jcfg = jnet.NetworkConfig(comm=jpc.PulseCommConfig(**comm_kw),
                              pipeline=pipeline, flow=_jax_flow(flow))
    cfg = net.NetworkConfig(comm=pc.PulseCommConfig(**comm_kw),
                            pipeline=pipeline, flow=flow)
    _, _, jtable, _, _ = _setup(b, min_delay=9, max_delay=14, seed=seed,
                                f=1)
    jparams = jnet.init_params(jax.random.PRNGKey(seed), jcfg, table=jtable)
    rng = np.random.default_rng(seed)
    w = np.round(rng.normal(0, 0.5, (N_CHIPS, N, N)) * 16) / 16
    jparams = jparams._replace(crossbar=jparams.crossbar._replace(
        w=jnp.asarray(w, jnp.float32)))
    ext = (rng.random((t, N_CHIPS, N)) < 0.25).astype(np.float32) * 3
    return jcfg, cfg, jparams, ext


def _jax_run(jcfg, jparams, jstate, ext):
    return jax.jit(lambda p, s, e: jnet.run(jcfg, p, s, e))(
        jparams, jstate, jnp.asarray(ext))


def _check_run(jrec, rec, jfinal, final):
    same(jrec.spikes, rec.spikes, "spikes")
    np.testing.assert_allclose(rec.voltage.numpy(), np.asarray(jrec.voltage),
                               rtol=0, atol=1e-5)
    same_stats(jrec.stats, rec.stats, "stats")
    same(jfinal.ring.ring, final.ring.ring, "ring")
    same(jfinal.ring.now, final.ring.now, "clock")
    for name in ("flow", "sendq"):
        if getattr(jfinal, name) is not None:
            for f in getattr(jfinal, name)._fields:
                same(getattr(getattr(jfinal, name), f),
                     getattr(getattr(final, name), f), f"{name}.{f}")


def test_network_run_pipelined_matches_serial_and_jax():
    """Voltages within 1e-5: PyTorch's and XLA's ``exp`` (the LIF decay)
    may differ in the last bit."""
    jcfg, cfg, jparams, ext = _network(True)
    params = convert.params_from_jax(jparams, device="cpu")
    jfinal, jrec = _jax_run(jcfg, jparams, jnet.init_state(jcfg, jparams),
                            ext)
    final, rec = net.run(cfg, params, net.init_state(cfg, params,
                                                     device="cpu"),
                         ext, device="cpu")
    assert rec.spikes.shape[0] == ext.shape[0]
    _check_run(jrec, rec, jfinal, final)
    assert int(final.pending.occupancy().sum()) == 0
    serial = dataclasses.replace(cfg, pipeline=False)
    sfinal, srec = net.run(serial, params, net.init_state(serial, params,
                                                          device="cpu"),
                           ext, device="cpu")
    assert torch.equal(srec.spikes, rec.spikes)
    assert torch.equal(srec.voltage, rec.voltage)
    for f in pc.CommStats._fields:
        assert torch.equal(getattr(srec.stats, f), getattr(rec.stats, f)), f
    assert torch.equal(sfinal.ring.ring, final.ring.ring)
    assert int(rec.spikes.sum()) > 0


@pytest.mark.parametrize("b", [1, 2, 4])
def test_pipelined_flow_with_send_queue_matches_jax(b):
    """Pipeline, credits and the send queue together: the gate binds
    (stalls and queued words) and everything stays bitwise."""
    flow = fb.FlowControlConfig(capacity=3, drain_rate=1,
                                retransmit_depth=16)
    jcfg, cfg, jtable, table, events = _setup(b, mode="full", rate=3,
                                              depth=6, min_delay=9, f=5,
                                              p=0.6, ring_depth=20)
    jfab, fab = _both(jcfg, cfg, flow)
    jring, ring = _rings(cfg)
    jres = jax.jit(jfab.run_pipelined)(_jax_events(events), jtable, jring)
    res = fab.run_pipelined(events, table, ring)
    same(jres.ring.ring, res.ring.ring, "ring")
    same(jres.delivered.words, res.delivered.words, "words")
    same_stats(jres.stats, res.stats, "stats")
    for f in jres.flow._fields:
        same(getattr(jres.flow, f), getattr(res.flow, f), f"flow.{f}")
    same(jres.sendq.words, res.sendq.words, "send queue")
    same(jres.sendq.dest, res.sendq.dest, "send queue dest")
    assert int(res.stats.stalled.sum()) > 0
    assert int(res.sendq.occupancy().sum()) > 0
    sent, acc = _totals(res.stats)
    queued = int(res.merge.occupancy().sum()) + int(
        res.sendq.occupancy().sum())
    assert sent == int(res.ring.ring.sum()) + acc + queued


def test_pipelined_flow_network_matches_jax():
    """The same on the network at B 2, with a send queue short enough to
    overflow into ``stalled``."""
    flow = fb.FlowControlConfig(capacity=2, drain_rate=1,
                                retransmit_depth=4)
    jcfg, cfg, jparams, ext = _network(True, flow, b=2, t=12)
    params = convert.params_from_jax(jparams, device="cpu")
    jfinal, jrec = _jax_run(jcfg, jparams, jnet.init_state(jcfg, jparams),
                            ext)
    final, rec = net.run(cfg, params, net.init_state(cfg, params,
                                                     device="cpu"),
                         ext, device="cpu")
    _check_run(jrec, rec, jfinal, final)
    assert int(rec.stats.stalled.sum()) > 0


def test_mid_run_jax_state_continues_bitwise():
    """A JAX state taken between two pipelined blocks (a full carry, the
    credits and the send queue mid-run) carried across by
    ``convert.state_from_jax``: the rest of the run equals JAX's."""
    b = 2
    flow = fb.FlowControlConfig(capacity=3, drain_rate=1,
                                retransmit_depth=16)
    jcfg, cfg, jparams, ext = _network(True, flow, b=b, t=10, seed=1)
    jfab = jnet.local_fabric(jcfg)
    jstate = jnet._ensure_carries(jfab, jnet.init_state(jcfg, jparams),
                                  pipeline=True)
    block = jax.jit(lambda p, s, e: jnet._block_impl(
        jcfg, jfab, p.table, p.neuron, p.crossbar.w, s, e)[0])
    for f in range(2):
        jstate = block(jparams, jstate, jnp.asarray(ext[f * b:(f + 1) * b]))
    assert int(np.asarray(jstate.pending.occupancy()).sum()) > 0
    assert int(np.asarray(jstate.sendq.occupancy()).sum()) > 0
    state = convert.state_from_jax(jstate, device="cpu")
    same_pending(jstate.pending, state.pending, "converted carry")
    jfinal, jrec = _jax_run(jcfg, jparams, jstate, ext[2 * b:])
    final, rec = net.run(cfg, convert.params_from_jax(jparams, device="cpu"),
                         state, ext[2 * b:], device="cpu")
    _check_run(jrec, rec, jfinal, final)
