"""Port parity, degraded routing and health masks: the route compiler
around dead chips and cut links, the degraded exchange (the detour relay
on a torus, the re-homed trunk on the tree), pods, and ``PulseFabric`` /
``NetworkConfig`` with ``healthy`` / ``dead_links`` (the reach cull into
``lost_to_failure`` at injection, serial, pipelined, fused and under
credit flow control, and the drain-side cull of a carry that arrives at
a dead chip), against the JAX package on the CPU, from inputs made with
numpy.

Tolerances as in tests/test_torch_topology.py: every integer output
bitwise (``lost_to_failure``, ``link_words``, ``link_backlog``
included), ``utilization`` within 1 f32 ulp.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import delays as jdl  # noqa: E402
from repro.core import fabric as jfb  # noqa: E402
from repro.core import pulse_comm as jpc  # noqa: E402
from repro.core import topology as jtp  # noqa: E402
from repro.snn import network as jnet  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import delays as dl  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import fabric as fb  # noqa: E402
from repro_torch.core import pulse_comm as pc  # noqa: E402
from repro_torch.core import topology as tpo  # noqa: E402
from repro_torch.snn import network as net  # noqa: E402
from test_torch_topology import (fabric_setup, jax_events,  # noqa: E402
                                 jax_exchange, port_exchange, rings, same,
                                 same_stats, shifted_dense, word_slabs)

DEGRADED_CASES = [
    (jtp.torus2d(3, 3, link_latency=0), (0, 1, 2, 3, 5, 6, 7, 8), ()),
    (jtp.torus2d(3, 3, link_latency=1), (0, 1, 2, 3, 5, 6, 7, 8), ()),
    (jtp.ring(6, link_latency=1), (0, 1, 2, 3, 4, 5), ((0, 0),)),
    (jtp.torus3d(2, 2, 2, link_latency=1), (0, 1, 2, 3, 4, 6, 7), ()),
    (jtp.switch_tree(3, 4, link_latency=1, trunk_latency=2),
     (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11), ()),
]
DIDS = ["torus3x3-lat0", "torus3x3", "ring-cut", "torus3d", "tree"]


def mask_pairs(x, healthy, n):
    """Sentinel out every slab whose source or destination is dead (the
    fabric's cull guarantees the transport sees no such traffic)."""
    alive = np.zeros(n, bool)
    alive[list(healthy)] = True
    return np.where((alive[:, None] & alive[None, :])[:, :, None], x, -1)


# ---------------------------------------------------------------------------
# The degraded route compiler
# ---------------------------------------------------------------------------

def test_normalize_health_forms():
    assert tpo.normalize_healthy(4, None) is None
    assert tpo.normalize_healthy(4, [3, 1]) == (1, 3)
    assert tpo.normalize_healthy(4, (0, 1, 2, 3)) is None
    assert tpo.normalize_healthy(4, np.array([True, False, True, True])) \
        == (0, 2, 3)
    assert tpo.normalize_dead_links([(2, 1), (0, 3)]) == ((0, 3), (2, 1))
    with pytest.raises(ValueError, match="shape"):
        tpo.normalize_healthy(4, np.ones(3, bool))
    with pytest.raises(ValueError, match="range"):
        tpo.normalize_healthy(4, [0, 4])
    with pytest.raises(ValueError, match="dead link"):
        tpo.compile_routes(tpo.ring(4), dead_links=((0, 2),))


@pytest.mark.parametrize("jtopo,healthy,dead_links", DEGRADED_CASES + [
    (jtp.direct(4), None, ((2, 0),)),
    (jtp.switch_tree(3, 4), (0, 1, 2, 4, 5, 6, 7, 8, 9, 10, 11),
     ((5, 2), (9, 3), (6, 0), (10, 1))),
    (jtp.pod(jtp.ring(3), 2), (0, 1, 2, 4, 5), ()),
    (jtp.torus2d(2, 23, link_latency=1),
     tuple(c for c in range(46) if c not in (7, 30)), ((12, 2),))],
    ids=DIDS + ["direct-cut", "tree-trunks", "pod", "torus2x23"])
def test_degraded_plan_and_carriers_equal_jax(jtopo, healthy, dead_links):
    topo = convert.topology_from_jax(jtopo)
    plan = tpo.compile_routes(topo, healthy, dead_links)
    jplan = jtp.compile_routes(jtopo, healthy, dead_links)
    for f in tpo.RoutePlan._fields:
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f),
                                      err_msg=f)
    if topo.kind == "switch_tree":
        h = tpo.normalize_healthy(topo.n_chips, healthy)
        d = tpo.normalize_dead_links(dead_links)
        for got, want in zip(tpo.tree_carriers(topo, h, d),
                             jtp.tree_carriers(jtopo, h, d)):
            np.testing.assert_array_equal(got, want)


def test_degraded_torus_routes_detour_around_dead_chip():
    """Kill the centre of a 3x3 torus: every surviving pair routes, no
    walk enters the dead chip, hops stay minimal and only lengthen."""
    topo, dead = tpo.torus2d(3, 3), 4
    healthy = tuple(c for c in range(9) if c != dead)
    plan = tpo.compile_routes(topo, healthy=healthy)
    base = tpo.compile_routes(topo)
    for s in healthy:
        for d in healthy:
            if s == d:
                continue
            c, h = s, 0
            while c != d:
                assert c != dead
                h += 1
                assert h <= 9
                c = int(plan.next[c, d])
            assert h == plan.hops[s, d] >= base.hops[s, d]
        assert plan.hops[s, dead] == -1 and plan.port[s, dead] == -1
        assert plan.hops[dead, s] == -1


def test_degraded_ring_cut_link_goes_the_long_way():
    plan = tpo.compile_routes(tpo.ring(6), dead_links=((0, 0),))
    assert (plan.hops[0, 1], plan.hops[1, 0], plan.hops[0, 5]) == (5, 5, 1)
    assert plan.latency[0, 1] == 5


def test_degraded_direct_link_kill_isolates_chip():
    plan = tpo.compile_routes(tpo.direct(4), dead_links=((2, 0),))
    for s in (0, 1, 3):
        assert plan.hops[s, 2] == plan.hops[2, s] == -1
        for d in (0, 1, 3):
            assert plan.hops[s, d] == (0 if s == d else 1)


def test_degraded_tree_rehomes_trunk_carrier():
    topo = tpo.switch_tree(3, 4)
    up, _ = tpo.tree_carriers(topo)
    carrier = int(up[0])
    healthy = tuple(c for c in range(12) if c != carrier)
    plan = tpo.compile_routes(topo, healthy=healthy)
    up2, _ = tpo.tree_carriers(topo, healthy)
    assert int(up2[0]) != carrier and int(up2[0]) // 4 == 0
    for s in healthy:
        for d in healthy:
            assert plan.hops[s, d] == (0 if s == d else
                                       2 if s // 4 == d // 4 else 4)


def test_degraded_plan_is_cached_and_pods_refuse_link_cuts():
    a = tpo.compile_routes(tpo.torus2d(3, 3), healthy=(0, 1, 2, 3, 5, 6, 7,
                                                       8))
    b = tpo.compile_routes(tpo.torus2d(3, 3), healthy=np.array(
        [1, 1, 1, 1, 0, 1, 1, 1, 1], bool))
    assert a is b
    assert tpo.compile_routes(tpo.ring(4), healthy=range(4)) is \
        tpo.compile_routes(tpo.ring(4))
    with pytest.raises(ValueError, match="pod"):
        tpo.compile_routes(tpo.pod(tpo.ring(3), 2), dead_links=((0, 0),))


# ---------------------------------------------------------------------------
# The degraded exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jtopo,healthy,dead_links", DEGRADED_CASES,
                         ids=DIDS)
def test_degraded_exchange_matches_jax(jtopo, healthy, dead_links):
    """Words, link words and backlog bitwise JAX's, on traffic with the
    dead chips' pairs masked (as the fabric leaves it) and, in a second
    exchange, unmasked (a torus delivers the sentinel for every pair it
    cannot reach); over the survivors the words are the dense exchange
    with the degraded plan's latency."""
    n = jtopo.n_chips
    raw = word_slabs(n + 5, n, 5)
    kw = dict(healthy=healthy, dead_links=dead_links)
    lat = jtp.compile_routes(jtopo, healthy, dead_links).latency
    hz = list(healthy)
    for x in (mask_pairs(raw, healthy, n), raw):
        jy, jw, jb = jax_exchange(jtopo, x, **kw)
        y, w, b = port_exchange(jtopo, x, **kw)
        same(jy, y, "words")
        same(jw, w, "link_words")
        same(jb, b, "link_backlog")
        np.testing.assert_array_equal(y.numpy()[hz][:, hz],
                                      shifted_dense(x, lat)[hz][:, hz])


@pytest.mark.parametrize("jtopo,healthy,dead_links", DEGRADED_CASES,
                         ids=DIDS)
def test_degraded_occupancy_matches_reference_walk(jtopo, healthy,
                                                   dead_links):
    n = jtopo.n_chips
    x = mask_pairs(word_slabs(n + 7, n, 6, p_valid=0.5), healthy, n)
    _, w, _ = port_exchange(jtopo, x, healthy=healthy, dead_links=dead_links)
    want = tpo.reference_link_words(convert.topology_from_jax(jtopo),
                                    (x >= 0).sum(-1), healthy=healthy,
                                    dead_links=dead_links)
    np.testing.assert_array_equal(w.numpy(), want)


@pytest.mark.parametrize("jpg,cpp", [(jtp.ring(3), 2), (jtp.direct(2), 3),
                                     (jtp.switch_tree(1, 2), 4)],
                         ids=["ring", "direct", "tree"])
def test_pod_delivery_and_occupancy_match_jax(jpg, cpp):
    """Pods: the dense member crossbar below a routed pod graph, bitwise
    JAX's (words, link words) and the numpy walk."""
    jtopo = jtp.pod(jpg, cpp)
    n = jtopo.n_chips
    x = word_slabs(n, n, 4)
    jy, jw, jb = jax_exchange(jtopo, x)
    y, w, b = port_exchange(jtopo, x)
    same(jy, y, "words")
    same(jw, w, "link_words")
    np.testing.assert_array_equal(
        w.numpy(), tpo.reference_link_words(convert.topology_from_jax(jtopo),
                                            (x >= 0).sum(-1)))
    np.testing.assert_array_equal(
        y.numpy(), shifted_dense(x, jtp.compile_routes(jtopo).latency))


# ---------------------------------------------------------------------------
# The fabric under a health mask
# ---------------------------------------------------------------------------

def both_fabrics(jcfg, cfg, jtopo, **kw):
    jflow = kw.pop("jflow", None)
    flow = kw.pop("flow", None)
    return (jfb.PulseFabric(jcfg, transport=jtopo, flow=jflow, **kw),
            fb.PulseFabric(cfg, transport=convert.topology_from_jax(jtopo),
                           flow=flow, device="cpu", **kw))


def test_lost_to_failure_conservation_matches_jax():
    """Ring of 6, chip 3 dead, per step: bitwise JAX's;
    sent == overflow + expired + deposited + lost_to_failure, lost > 0,
    no traffic to or from the dead chip; full health loses nothing."""
    n, dead = 6, 3
    healthy = tuple(c for c in range(n) if c != dead)
    jtopo = jtp.ring(n, link_latency=0)
    total_lost = 0
    jcfg, cfg, *_ = fabric_setup(n, n_neurons=24)
    jfab, fab = both_fabrics(jcfg, cfg, jtopo, healthy=healthy)
    jstep = jax.jit(jfab.step)
    for step in range(3):
        _, _, jtable, table, events = fabric_setup(n, seed=step,
                                                   n_neurons=24)
        jring, ring = rings(cfg)
        blk = ev.EventBuffer(*(x[0, 0] for x in events))
        res = fab.step(blk, table, ring)
        same_stats(jstep(jax_events(blk), jtable, jring).stats,
                   res.stats, f"step {step}")
        s = res.stats
        lost = int(s.lost_to_failure.sum())
        assert int(s.sent.sum()) == (int(s.overflow.sum())
                                     + int(s.expired.sum())
                                     + int(res.ring.ring.sum()) + lost)
        assert int(s.traffic[dead].sum()) == int(s.traffic[:, dead].sum()) \
            == 0
        total_lost += lost
    assert total_lost > 0
    full = fb.PulseFabric(cfg, transport=tpo.ring(n, link_latency=0),
                          device="cpu").step(blk, table, ring)
    assert int(full.stats.lost_to_failure.sum()) == 0


def test_degrade_swaps_the_plan_and_full_health_is_the_identity():
    n = 6
    healthy = (0, 1, 3, 4, 5)
    _, cfg, _, table, events = fabric_setup(n, n_neurons=24)
    _, ring = rings(cfg)
    blk = ev.EventBuffer(*(x[0, 0] for x in events))
    base = fb.PulseFabric(cfg, transport=tpo.ring(n, link_latency=0),
                          device="cpu")
    a = base.degrade(healthy=healthy).step(blk, table, ring)
    b = fb.PulseFabric(cfg, transport=tpo.ring(n, link_latency=0),
                       healthy=healthy, device="cpu").step(blk, table, ring)
    assert torch.equal(a.ring.ring, b.ring.ring)
    assert int(a.stats.lost_to_failure.sum()) > 0
    assert base.degrade().reach is None
    c = base.degrade().step(blk, table, ring)
    assert torch.equal(c.ring.ring, base.step(blk, table, ring).ring.ring)


def test_dead_links_need_a_topology_but_dense_takes_dead_chips():
    _, cfg, _, table, events = fabric_setup(4)
    with pytest.raises(ValueError, match="dead_links"):
        fb.PulseFabric(cfg, dead_links=((0, 0),), device="cpu")
    fab = fb.PulseFabric(cfg, healthy=(0, 1, 3), device="cpu")
    assert bool(fab.reach[2].any()) is False
    assert bool(fab.reach[0, 1]) and not bool(fab.reach[0, 2])


def test_degraded_supersteps_match_jax():
    """Serial supersteps on a degraded switch tree (dead chip, cut trunk
    share and leaf link), fan-out 2 (the packed path: route, cull, admit,
    one ``bucket_pack``), B 4, bitwise JAX's; the fused path with its
    reach row is held by the network and fused-path tests below."""
    jtopo = jtp.switch_tree(2, 4, link_latency=1, link_bandwidth=4)
    healthy, dead_links, fanout, b = (0, 1, 2, 3, 5, 6, 7), ((4, 2), (6, 0)), \
        2, 4
    jcfg, cfg, jtable, table, events = fabric_setup(
        8, b=b, fanout=fanout, mode="full", rate=3, bpc=2, cap=4, f=2,
        min_delay=6, max_delay=11, p=0.6)
    jfab, fab = both_fabrics(jcfg, cfg, jtopo, healthy=healthy,
                             dead_links=dead_links)
    jring, ring = rings(cfg)
    jmerge, merge = jfab.init_merge(), fab.init_merge()
    jstep = jax.jit(jfab.superstep)
    lost = 0
    for f in range(events.addr.shape[0]):
        blk = ev.EventBuffer(*(x[f] for x in events))
        jres = jstep(jax_events(blk), jtable, jring, None, jmerge)
        res = fab.superstep(blk, table, ring, None, merge)
        same(jres.ring.ring, res.ring.ring, f"ring {f}")
        same(jres.delivered.words, res.delivered.words, f"words {f}")
        same_stats(jres.stats, res.stats, f"block {f}")
        same(jres.merge.words, res.merge.words, f"merge {f}")
        lost += int(res.stats.lost_to_failure.sum())
        jring = jdl.DelayRing(jres.ring.ring, jres.ring.now + b)
        ring = dl.DelayRing(res.ring.ring, res.ring.now + b)
        jmerge, merge = jres.merge, res.merge
    assert lost > 0


def test_fused_path_with_a_health_mask_matches_jax_fused_path():
    """``use_pallas=True`` in JAX (its fused inject and drain, in
    interpret mode) against the port's fused path, fan-out 1, one block
    of B 2 in simplified mode, on a degraded torus: bitwise."""
    b = 2
    jtopo = jtp.torus2d(2, 3, link_latency=1)
    healthy, dead_links = (0, 1, 2, 3, 5), ((0, 2),)
    jcfg, cfg, jtable, table, events = fabric_setup(
        6, b=b, bpc=2, cap=4, f=1, min_delay=6, max_delay=11, p=0.6)
    jcfg = jpc.PulseCommConfig(**dict(vars(jcfg), use_pallas=True))
    jfab, fab = both_fabrics(jcfg, cfg, jtopo, healthy=healthy,
                             dead_links=dead_links)
    jring, ring = rings(cfg)
    jmerge, merge = jfab.init_merge(), fab.init_merge()
    jstep = jax.jit(jfab.superstep)
    for f in range(events.addr.shape[0]):
        blk = ev.EventBuffer(*(x[f] for x in events))
        jres = jstep(jax_events(blk), jtable, jring, None, jmerge)
        res = fab.superstep(blk, table, ring, None, merge)
        same(jres.ring.ring, res.ring.ring, f"ring {f}")
        same_stats(jres.stats, res.stats, f"block {f}")
        jring = jdl.DelayRing(jres.ring.ring, jres.ring.now + b)
        ring = dl.DelayRing(res.ring.ring, res.ring.now + b)
        jmerge, merge = jres.merge, res.merge
    assert int(res.stats.lost_to_failure.sum()) > 0


@pytest.mark.parametrize("b", [2])
def test_credit_flow_control_over_a_degraded_topology_matches_jax(b):
    """Credits and the send queue on a degraded switch tree: the
    per-substep loop culls after the requeue (a queued word for a dead
    chip is lost, not expired); stalls, queue and lost bitwise JAX's."""
    jtopo = jtp.switch_tree(2, 4, link_latency=1, trunk_latency=1)
    healthy = (0, 1, 2, 3, 4, 6, 7)
    flow = fb.FlowControlConfig(capacity=3, drain_rate=1,
                                retransmit_depth=12)
    jflow = jfb.FlowControlConfig(capacity=3, drain_rate=1,
                                  retransmit_depth=12)
    jcfg, cfg, jtable, table, events = fabric_setup(
        8, b=b, mode="full", rate=3, bpc=2, cap=4, f=3, min_delay=6,
        max_delay=11, p=0.6)
    jfab, fab = both_fabrics(jcfg, cfg, jtopo, healthy=healthy, flow=flow,
                             jflow=jflow)
    jring, ring = rings(cfg)
    jres = jax.jit(jfab.run_pipelined)(jax_events(events), jtable, jring)
    res = fab.run_pipelined(events, table, ring)
    same(jres.ring.ring, res.ring.ring, "ring")
    same_stats(jres.stats, res.stats)
    for f in jres.flow._fields:
        same(getattr(jres.flow, f), getattr(res.flow, f), f"flow.{f}")
    same(jres.sendq.words, res.sendq.words, "send queue")
    s = res.stats
    assert int(s.lost_to_failure.sum()) > 0
    assert int(s.stalled.sum()) + int(res.sendq.occupancy().sum()) > 0
    queued = int(res.merge.occupancy().sum()) + int(
        res.sendq.occupancy().sum())
    acc = sum(int(getattr(s, k).sum()) for k in (
        "overflow", "expired", "stalled", "merge_dropped", "lost_to_failure"))
    assert int(s.sent.sum()) == int(res.ring.ring.sum()) + acc + queued


def test_carry_across_a_failure_is_culled_at_the_dead_chip():
    """A pipeline carry issued at full health and drained by the degraded
    fabric (``degrade()`` between two stages): words that arrive at the
    dead chip are culled into lost_to_failure, bitwise JAX's."""
    b = 2
    jtopo = jtp.switch_tree(2, 4, link_latency=1, trunk_latency=1)
    healthy = (0, 1, 2, 3, 4, 5, 7)
    jcfg, cfg, jtable, table, events = fabric_setup(
        8, b=b, mode="full", rate=3, bpc=2, cap=4, f=3, min_delay=6,
        max_delay=11, p=0.6, ring_depth=24)
    jfab, fab = both_fabrics(jcfg, cfg, jtopo)
    jring, ring = rings(cfg)
    jmerge, merge = jfab.init_merge(), fab.init_merge()
    jpend, pend = jfab.init_pending(), fab.init_pending()
    jstep = jax.jit(jfab.pipeline_block)
    for f in range(events.addr.shape[0]):
        if f == 2:
            jfab, fab = jfab.degrade(healthy=healthy), fab.degrade(
                healthy=healthy)
            jstep = jax.jit(jfab.pipeline_block)
        blk = ev.EventBuffer(*(x[f] for x in events))
        jres = jstep(jax_events(blk), jtable, jring, None, jmerge, None,
                     jpend)
        res = fab.pipeline_block(blk, table, ring, None, merge, None, pend)
        same(jres.ring.ring, res.ring.ring, f"ring {f}")
        same_stats(jres.stats, res.stats, f"stage {f}")
        jring = jdl.DelayRing(jres.ring.ring, jres.ring.now + b)
        ring = dl.DelayRing(res.ring.ring, res.ring.now + b)
        jmerge, merge, jpend, pend = (jres.merge, res.merge, jres.pending,
                                      res.pending)
        if f == 2:
            # Stage 2 drained block 1, issued at full health.
            assert int(res.stats.lost_to_failure[:, 6].sum()) > 0
    jres = jax.jit(jfab.flush_pending)(jring, jpend, None, jmerge)
    res = fab.flush_pending(ring, pend, None, merge)
    same_stats(jres.stats, res.stats, "flush")


def test_degraded_network_matches_jax():
    """``NetworkConfig(topology=torus2d, healthy=..., dead_links=...)``,
    fan-out 1 (the fused inject with its reach row), B 2: spikes, ring and
    every integer stat bitwise JAX's (voltages within 1e-5)."""
    n, nn, b = 8, 16, 2
    jtopo = jtp.torus2d(2, 4, link_latency=1)
    health = dict(healthy=(0, 1, 2, 3, 4, 6, 7), dead_links=((1, 2),))
    comm_kw = dict(n_chips=n, neurons_per_chip=nn, n_inputs_per_chip=nn,
                   event_capacity=nn, bucket_capacity=8, buckets_per_chip=2,
                   mode="full", merge_rate=4, ring_depth=20, superstep=b)
    jcfg = jnet.NetworkConfig(comm=jpc.PulseCommConfig(**comm_kw),
                              topology=jtopo, **health)
    cfg = net.NetworkConfig(comm=pc.PulseCommConfig(**comm_kw),
                            topology=convert.topology_from_jax(jtopo),
                            **health)
    _, _, jtable, _, _ = fabric_setup(n, n_neurons=nn, min_delay=5,
                                      max_delay=10, seed=4)
    jparams = jnet.init_params(jax.random.PRNGKey(4), jcfg, table=jtable)
    rng = np.random.default_rng(4)
    w = np.round(rng.normal(0, 0.5, (n, nn, nn)) * 16) / 16
    jparams = jparams._replace(crossbar=jparams.crossbar._replace(
        w=jnp.asarray(w, jnp.float32)))
    ext = (rng.random((12, n, nn)) < 0.3).astype(np.float32) * 3
    jfinal, jrec = jax.jit(lambda p, s, e: jnet.run(jcfg, p, s, e))(
        jparams, jnet.init_state(jcfg, jparams), jnp.asarray(ext))
    params = convert.params_from_jax(jparams, device="cpu")
    final, rec = net.run(cfg, params, net.init_state(cfg, params,
                                                     device="cpu"),
                         ext, device="cpu")
    same(jrec.spikes, rec.spikes, "spikes")
    np.testing.assert_allclose(rec.voltage.numpy(), np.asarray(jrec.voltage),
                               rtol=0, atol=1e-5)
    same_stats(jrec.stats, rec.stats)
    same(jfinal.ring.ring, final.ring.ring, "ring")
    assert int(rec.stats.lost_to_failure.sum()) > 0
