"""Port parity, switched topologies: ``repro_torch.core.topology`` (the
graphs, ``compile_routes``, ``reference_link_words``, ``RoutedTransport``)
and ``PulseFabric`` / ``NetworkConfig`` over a topology, against the JAX
package on the CPU, from inputs made with numpy.

The JAX side runs as ``tests/test_topology.py`` runs it: ``jax.vmap``
with a named axis around ``RoutedTransport.exchange_words``, and
``PulseFabric(cfg, transport=topo)``.  Tolerances: the route tables,
delivered words, rings, queues, carries and every integer ``CommStats``
field (``link_words`` and ``link_backlog`` included) bitwise;
``utilization`` (an f32 mean) within 1 f32 ulp.
"""

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
from repro.core import topology as jtp  # noqa: E402
from repro.snn import network as jnet  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import delays as dl  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import fabric as fb  # noqa: E402
from repro_torch.core import pulse_comm as pc  # noqa: E402
from repro_torch.core import routing as rt  # noqa: E402
from repro_torch.core import topology as tpo  # noqa: E402
from repro_torch.core import transport as tp  # noqa: E402
from repro_torch.snn import network as net  # noqa: E402

AXIS = "_test_torch_topo_chip"
T0 = 250

# The nine topologies of tests/test_topology.py, as (JAX, port) pairs.
JTOPOLOGIES = [
    jtp.direct(6), jtp.ring(5), jtp.ring(6), jtp.torus2d(3, 4),
    jtp.torus2d(4, 4), jtp.torus3d(2, 2, 2), jtp.switch_tree(3, 4),
    jtp.switch_tree(1, 4), jtp.torus2d(1, 4)]
IDS = [f"{t.kind}{t.dims}{t.n_chips}" for t in JTOPOLOGIES]


def same(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=msg)


def same_stats(want, got, msg=""):
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f == "utilization":
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            np.testing.assert_array_equal(w, g, err_msg=f"{msg} {f}")


def word_slabs(seed, n, lanes, p_valid=0.7):
    """Random wire-word slabs [n(src), n(dst), lanes] (numpy int32)."""
    rng = np.random.default_rng(seed)
    addr = rng.integers(0, 1 << ev.ADDR_BITS, (n, n, lanes))
    time = rng.integers(0, 4 * ev.TIME_MOD, (n, n, lanes))
    valid = rng.random((n, n, lanes)) < p_valid
    return np.where(valid, (addr << 8) | (time & 255), -1).astype(np.int32)


def jax_exchange(jtopo, x, **kw):
    tr = jtp.RoutedTransport(topology=jtopo, axis=AXIS, **kw)
    return jax.jit(jax.vmap(lambda s: tr.exchange_words(s),
                            axis_name=AXIS))(jnp.asarray(x))


def port_exchange(jtopo, x, **kw):
    tr = tpo.RoutedTransport(topology=convert.topology_from_jax(jtopo), **kw)
    return tr.exchange_words(torch.as_tensor(x))


def shifted_dense(x, lat):
    """The dense exchange ``[dst, src, ...]`` with each valid word's
    timestamp shifted by ``lat[src, dst]`` (clamped at 0)."""
    dense = np.swapaxes(x, 0, 1)
    dt = np.maximum(lat.T, 0)[:, :, None]
    t8 = ((dense & ev.WORD_TIME_MASK) + dt) & ev.WORD_TIME_MASK
    return np.where(dense >= 0, (dense & ~ev.WORD_TIME_MASK) | t8, dense)


# ---------------------------------------------------------------------------
# Graphs and the route compiler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jtopo", JTOPOLOGIES, ids=IDS)
def test_route_tables_equal_jax_and_walk_to_destination(jtopo):
    """Every RoutePlan array equals JAX's; following next[] reaches the
    destination in exactly hops[] steps, on valid ports."""
    topo = convert.topology_from_jax(jtopo)
    plan, jplan = tpo.compile_routes(topo), jtp.compile_routes(jtopo)
    for f in tpo.RoutePlan._fields:
        np.testing.assert_array_equal(getattr(plan, f), getattr(jplan, f),
                                      err_msg=f)
    assert (topo.n_ports, topo.port_names, topo.link_capacity) == (
        jtopo.n_ports, jtopo.port_names, jtopo.link_capacity)
    n = topo.n_chips
    for s in range(n):
        assert plan.port[s, s] == -1 and plan.hops[s, s] == 0
        for d in range(n):
            if s == d:
                continue
            assert 0 <= plan.port[s, d] < topo.n_ports
            if topo.kind == "switch_tree":
                continue
            c, h = s, 0
            while c != d:
                h += 1
                assert h <= n, "routing loop"
                c = int(plan.next[c, d])
            assert h == plan.hops[s, d]


def test_torus_routing_is_dimension_ordered_with_min_hops():
    plan = tpo.compile_routes(tpo.torus2d(4, 4))
    for s in range(16):
        for d in range(16):
            c, seen_dim1 = s, False
            while c != d:
                if int(plan.port[c, d]) // 2 == 1:
                    seen_dim1 = True
                else:
                    assert not seen_dim1, "dim0 hop after dim1 hop"
                c = int(plan.next[c, d])
            sx, sy, dx, dy = s // 4, s % 4, d // 4, d % 4
            assert plan.hops[s, d] == (min((dx - sx) % 4, (sx - dx) % 4)
                                       + min((dy - sy) % 4, (sy - dy) % 4))
    assert plan.hops.max() == 4


def test_switch_tree_up_down_latency():
    plan = tpo.compile_routes(tpo.switch_tree(3, 4, link_latency=2,
                                              trunk_latency=5))
    for s in range(12):
        for d in range(12):
            want = ((0, 0) if s == d else (2, 4) if s // 4 == d // 4
                    else (4, 14))
            assert (plan.hops[s, d], plan.latency[s, d]) == want


@pytest.mark.parametrize("kw", [
    dict(kind="torus", n_chips=6, dims=(2, 2)),
    dict(kind="switch_tree", n_chips=7, chips_per_group=4),
    dict(kind="mesh", n_chips=4), dict(kind="direct", n_chips=0),
    dict(kind="pod", n_chips=4, chips_per_group=2),
    dict(kind="direct", n_chips=3, link_latency=-1)])
def test_topology_constructor_validation(kw):
    with pytest.raises(ValueError):
        jtp.Topology(**kw)
    with pytest.raises(ValueError):
        tpo.Topology(**kw)


def test_group_and_pod_counts_and_capacity():
    assert tpo.switch_tree(3, 4).n_groups == 3
    assert tpo.pod(tpo.ring(3), 2).n_pods == 3
    assert tpo.pod(tpo.torus2d(2, 2), 2).n_ports == 5
    with pytest.raises(ValueError, match="n_groups"):
        tpo.ring(4).n_groups
    assert tpo.ring(4, link_bandwidth=4, link_credits=2).link_capacity == 2
    assert tpo.ring(4).link_capacity == 0


# ---------------------------------------------------------------------------
# RoutedTransport
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jtopo", JTOPOLOGIES, ids=IDS)
def test_routed_delivery_matches_jax_and_dense_modulo_latency(jtopo):
    """Delivered words, link words and backlog bitwise JAX's; the words
    are the dense exchange with the path latency on the timestamp."""
    n = jtopo.n_chips
    x = word_slabs(n, n, 5)
    jy, jw, jb = jax_exchange(jtopo, x)
    y, w, b = port_exchange(jtopo, x)
    same(jy, y, "words")
    same(jw, w, "link_words")
    same(jb, b, "link_backlog")
    np.testing.assert_array_equal(
        y.numpy(), shifted_dense(x, jtp.compile_routes(jtopo).latency))


def test_zero_latency_is_bitwise_dense():
    x = torch.as_tensor(word_slabs(3, 16, 6))
    y, _, _ = tpo.RoutedTransport(
        topology=tpo.torus2d(4, 4, link_latency=0)).exchange_words(x)
    assert torch.equal(y, tp.LocalTransport(16).exchange_words_start(x)[0])


@pytest.mark.parametrize("jtopo", [
    jtp.ring(6, link_latency=1), jtp.torus2d(3, 4, link_latency=1),
    jtp.torus3d(2, 3, 2, link_latency=1),
    jtp.switch_tree(3, 4, link_latency=1, trunk_latency=2),
    jtp.direct(5, link_latency=2)], ids=lambda t: f"{t.kind}{t.dims}")
def test_link_occupancy_matches_route_walk(jtopo):
    """The counters equal the numpy walk of the compiled tables (the
    port's ``reference_link_words``, itself equal to JAX's), transit
    words included."""
    n = jtopo.n_chips
    x = word_slabs(n + 31, n, 6, p_valid=0.5)
    _, w, b = port_exchange(jtopo, x)
    traffic = (x >= 0).sum(-1)
    want = tpo.reference_link_words(convert.topology_from_jax(jtopo),
                                    traffic)
    np.testing.assert_array_equal(want,
                                  jtp.reference_link_words(jtopo, traffic))
    np.testing.assert_array_equal(w.numpy(), want)
    assert int(b.sum()) == 0


@pytest.mark.parametrize("jtopo,rounds", [
    (jtp.ring(4, link_bandwidth=2), 1), (jtp.torus2d(3, 4, link_credits=3), 3),
    (jtp.switch_tree(3, 4, link_bandwidth=5), 3),
    (jtp.direct(5, link_bandwidth=3), 1),
    (jtp.pod(jtp.torus2d(2, 2, link_bandwidth=2), 2, link_bandwidth=3), 2)],
    ids=["ring", "torus", "tree", "direct", "pod"])
def test_link_backlog_counts_capacity_excess(jtopo, rounds):
    """Backlog per round (torus), per exchange (tree, direct, the pod's
    crossbar) against each level's own capacity times the flush rounds,
    bitwise JAX's."""
    n = jtopo.n_chips
    x = word_slabs(n + rounds, n, 8, p_valid=0.9)
    _, jw, jb = jax_exchange(jtopo, x, flush_rounds=rounds)
    _, w, b = port_exchange(jtopo, x, flush_rounds=rounds)
    same(jw, w, "link_words")
    same(jb, b, "link_backlog")
    assert int(b.sum()) > 0 and bool((b <= w).all())


def test_transit_traffic_is_counted():
    """Ring of 4: chip 0's words for chip 2 occupy chip 1's forward
    port."""
    x = np.full((4, 4, 2), -1, np.int32)
    x[0, 2] = [(5 << 8) | 1, (9 << 8) | 2]
    _, w, _ = tpo.RoutedTransport(topology=tpo.ring(4)).exchange_words(
        torch.as_tensor(x))
    np.testing.assert_array_equal(w.numpy(), [[2, 0], [2, 0], [0, 0],
                                              [0, 0]])


def test_exchange_halves_compose_and_check_the_shape():
    topo = tpo.torus2d(3, 4, link_latency=2)
    tr = tpo.RoutedTransport(topology=topo)
    x = torch.as_tensor(word_slabs(7, 12, 3))
    y, w, b = tr.exchange_words(x)
    y0, w0, b0 = tr.exchange_words_start(x)
    assert torch.equal(y0, x.transpose(0, 1))       # unshifted
    assert torch.equal(tr.exchange_words_finish(y0), y)
    assert torch.equal(w0, w) and torch.equal(b0, b)
    assert tr.max_path_latency == 2 * 3
    with pytest.raises(ValueError, match="n_chips"):
        tr.exchange_words(x[:11])


# ---------------------------------------------------------------------------
# PulseFabric over a topology
# ---------------------------------------------------------------------------

def fabric_setup(n, *, b=1, n_neurons=16, mode="simplified", bpc=1, rate=0,
                 fanout=1, f=1, seed=0, min_delay=6, max_delay=8, cap=8,
                 ring_depth=16, p=0.5):
    """Both configs, the LUT (JAX and port) and ``f`` blocks of events
    ``[F, B, n_chips, E]``, clocks from ``T0`` across the 8-bit wrap."""
    kw = dict(n_chips=n, neurons_per_chip=n_neurons,
              n_inputs_per_chip=n_neurons, event_capacity=n_neurons,
              fanout=fanout, bucket_capacity=cap, buckets_per_chip=bpc,
              ring_depth=ring_depth, mode=mode, merge_rate=rate,
              merge_depth=6, superstep=b)
    rng = np.random.default_rng(seed)
    shape = (n, n_neurons, fanout)
    table = rt.RoutingTable(
        dest_chip=torch.as_tensor(rng.integers(0, n, shape),
                                  dtype=torch.int32),
        dest_addr=torch.as_tensor(rng.integers(0, n_neurons, shape),
                                  dtype=torch.int32),
        delay=torch.as_tensor(rng.integers(min_delay, max_delay + 1, shape),
                              dtype=torch.int32),
        valid=torch.as_tensor(rng.random(shape) < 0.95))
    jtable = jrt.RoutingTable(*(jnp.asarray(x.numpy()) for x in table))
    spikes = torch.as_tensor(rng.random((f * b, n, n_neurons)) < p)
    bufs = [ev.from_spikes(spikes[t], T0 + t, n_neurons)[0]
            for t in range(f * b)]
    events = ev.EventBuffer(*(torch.stack(x).reshape((f, b) + x[0].shape)
                              for x in zip(*bufs)))
    return jpc.PulseCommConfig(**kw), pc.PulseCommConfig(**kw), jtable, \
        table, events


def jax_events(events):
    return jev.EventBuffer(*(jnp.asarray(x.numpy()) for x in events))


def rings(cfg):
    n, d, m = cfg.n_chips, cfg.ring_depth, cfg.n_inputs_per_chip
    return (jax.vmap(lambda _: jdl.init(d, m, now=T0))(jnp.arange(n)),
            dl.init(d, m, now=T0, batch_shape=(n,)))


@pytest.mark.parametrize("jtopo", [
    jtp.torus2d(4, 4, link_latency=0),
    jtp.switch_tree(4, 4, link_latency=0, trunk_latency=0),
    jtp.ring(16, link_latency=0)], ids=lambda t: f"{t.kind}{t.dims}")
def test_fabric_over_topology_zero_latency_matches_dense_and_jax(jtopo):
    """Zero latency: rings, delivered words and drop accounting equal the
    dense fabric's; every output equals the JAX fabric over the same
    topology, ``link_words [n_chips, n_ports]`` included."""
    jcfg, cfg, jtable, table, events = fabric_setup(16)
    jring, ring = rings(cfg)
    blk = ev.EventBuffer(*(x[0, 0] for x in events))
    topo = convert.topology_from_jax(jtopo)
    dense = fb.PulseFabric(cfg, device="cpu").step(blk, table, ring)
    routed = fb.PulseFabric(cfg, transport=topo, device="cpu").step(
        blk, table, ring)
    assert torch.equal(routed.ring.ring, dense.ring.ring)
    assert torch.equal(routed.delivered.words, dense.delivered.words)
    for f in ("sent", "overflow", "expired", "wire_bytes", "traffic"):
        assert torch.equal(getattr(routed.stats, f), getattr(dense.stats, f))
    assert routed.stats.link_words.shape == (16, topo.n_ports)
    assert int(routed.stats.link_words.sum()) > 0
    jres = jax.jit(jfb.PulseFabric(jcfg, transport=jtopo).step)(
        jax_events(blk), jtable, jring)
    same(jres.ring.ring, routed.ring.ring, "ring")
    same(jres.delivered.words, routed.delivered.words, "words")
    same_stats(jres.stats, routed.stats)


@pytest.mark.parametrize("jtopo", [
    jtp.switch_tree(2, 4, link_latency=1, trunk_latency=1, link_credits=4),
    jtp.torus2d(2, 4, link_latency=1, link_bandwidth=2)],
    ids=["switch_tree", "torus2d"])
def test_pipelined_schedule_over_topology_matches_jax(jtopo):
    """run_pipelined over a topology (the carry's link leg has 4 ports),
    bitwise JAX's (``link_backlog`` judged against B rounds of capacity
    included), and equal to the serial supersteps: delays 8..12 plus
    path latency exceed the two-block wait 2B - 1 = 7."""
    b = 4
    jcfg, cfg, jtable, table, events = fabric_setup(
        8, b=b, mode="full", rate=3, bpc=2, cap=6, f=3, min_delay=8,
        max_delay=12, ring_depth=24)
    topo = convert.topology_from_jax(jtopo)
    fab = fb.PulseFabric(cfg, transport=topo, device="cpu")
    jfab = jfb.PulseFabric(jcfg, transport=jtopo)
    jring, ring = rings(cfg)
    assert fab.init_pending().link.words.shape == (8, 4)
    jres = jax.jit(jfab.run_pipelined)(jax_events(events), jtable, jring)
    res = fab.run_pipelined(events, table, ring)
    same(jres.ring.ring, res.ring.ring, "ring")
    same(jres.delivered.words, res.delivered.words, "words")
    same_stats(jres.stats, res.stats)
    same(jres.merge.words, res.merge.words, "merge")
    merge, serial = fab.init_merge(), []
    for f in range(events.addr.shape[0]):
        sres = fab.superstep(ev.EventBuffer(*(x[f] for x in events)), table,
                             ring, None, merge)
        merge = sres.merge
        ring = dl.DelayRing(sres.ring.ring, sres.ring.now + b)
        serial.append(sres.stats.link_words)
    assert torch.equal(ring.ring, res.ring.ring)
    assert torch.equal(torch.stack(serial), res.stats.link_words)
    assert int(res.stats.link_backlog.sum()) > 0


def test_mid_run_jax_carry_with_port_links_continues_bitwise():
    """A JAX pipeline carry over a switch tree (link leg [n_chips, 4])
    taken after two stages, carried across by
    ``convert.pending_from_jax``: the rest of the run equals JAX's."""
    b = 2
    jtopo = jtp.switch_tree(2, 4, link_latency=1, trunk_latency=2)
    jcfg, cfg, jtable, table, events = fabric_setup(
        8, b=b, mode="full", rate=3, bpc=2, cap=6, f=4, min_delay=5,
        max_delay=9, ring_depth=24)
    jfab = jfb.PulseFabric(jcfg, transport=jtopo)
    fab = fb.PulseFabric(cfg, transport=convert.topology_from_jax(jtopo),
                         device="cpu")
    jring, _ = rings(cfg)
    jmerge, jpend = jfab.init_merge(), jfab.init_pending()
    jstep = jax.jit(jfab.pipeline_block)
    for f in range(2):
        jres = jstep(jax_events(ev.EventBuffer(*(x[f] for x in events))),
                     jtable, jring, None, jmerge, None, jpend)
        jring = jdl.DelayRing(jres.ring.ring, jres.ring.now + b)
        jmerge, jpend = jres.merge, jres.pending
    assert np.asarray(jpend.link.words).shape == (8, 4)
    assert int(np.asarray(jpend.link.words).sum()) > 0
    pend = convert.pending_from_jax(jpend, device="cpu")
    same(jpend.link.words, pend.link.words, "carried link words")
    ring = dl.DelayRing(convert.tensor(jring.ring, "cpu"),
                        convert.tensor(jring.now, "cpu"))
    merge = fab.init_merge()._replace(
        words=convert.tensor(jmerge.words, "cpu"))
    for f in range(2, 4):
        blk = ev.EventBuffer(*(x[f] for x in events))
        jres = jstep(jax_events(blk), jtable, jring, None, jmerge, None,
                     jpend)
        res = fab.pipeline_block(blk, table, ring, None, merge, None, pend)
        same(jres.ring.ring, res.ring.ring, f"ring {f}")
        same_stats(jres.stats, res.stats, f"stage {f}")
        same(jres.pending.words, res.pending.words, f"carry {f}")
        jring = jdl.DelayRing(jres.ring.ring, jres.ring.now + b)
        ring = dl.DelayRing(res.ring.ring, res.ring.now + b)
        jmerge, jpend, merge, pend = (jres.merge, jres.pending, res.merge,
                                      res.pending)
    jres = jax.jit(jfab.flush_pending)(jring, jpend, None, jmerge)
    res = fab.flush_pending(ring, pend, None, merge)
    same(jres.ring.ring, res.ring.ring, "flushed ring")
    same_stats(jres.stats, res.stats, "flush")


def test_fabric_guards():
    """Latency past the wrap window, the superstep and pipeline guards
    widened by it, and the chip count."""
    cfg = pc.PulseCommConfig(n_chips=4, neurons_per_chip=8,
                             n_inputs_per_chip=8, ring_depth=16)
    with pytest.raises(ValueError, match="wrap"):
        fb.PulseFabric(cfg, transport=tpo.ring(4, link_latency=100),
                       device="cpu")
    with pytest.raises(ValueError, match="chips"):
        fb.PulseFabric(cfg, transport=tpo.ring(8), device="cpu")
    b8 = pc.PulseCommConfig(n_chips=4, neurons_per_chip=8,
                            n_inputs_per_chip=8, ring_depth=100, superstep=8)
    fb.PulseFabric(b8, transport=tpo.ring(4, link_latency=9), device="cpu")
    with pytest.raises(ValueError, match="path latency 20"):
        fb.PulseFabric(b8, transport=tpo.ring(4, link_latency=10),
                       device="cpu")
    fab = fb.PulseFabric(b8, transport=tpo.ring(4, link_latency=6),
                         device="cpu")                 # 8 + 12 + 100 < 128
    with pytest.raises(ValueError, match="path latency 12"):
        fab._check_pipeline_guard()
    fb.PulseFabric(b8, device="cpu")._check_pipeline_guard()


def test_overlong_path_latency_expires_instead_of_ghosting():
    """Transit of up to 24 steps against delays of 6..8: more expired
    than on the dense fabric, conservation closes, as JAX's."""
    jtopo = jtp.ring(8, link_latency=6)
    jcfg, cfg, jtable, table, events = fabric_setup(8)
    jring, ring = rings(cfg)
    blk = ev.EventBuffer(*(x[0, 0] for x in events))
    dense = fb.PulseFabric(cfg, device="cpu").step(blk, table, ring)
    routed = fb.PulseFabric(cfg, transport=convert.topology_from_jax(jtopo),
                            device="cpu").step(blk, table, ring)
    assert int(routed.stats.expired.sum()) > int(dense.stats.expired.sum())
    s = routed.stats
    assert int(s.sent.sum()) == (int(s.overflow.sum()) + int(s.expired.sum())
                                 + int(routed.ring.ring.sum()))
    jres = jax.jit(jfb.PulseFabric(jcfg, transport=jtopo).step)(
        jax_events(blk), jtable, jring)
    same_stats(jres.stats, s)


# ---------------------------------------------------------------------------
# Networks over a topology
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topo", [
    tpo.torus2d(4, 4, link_latency=1),
    tpo.switch_tree(4, 4, link_latency=1, trunk_latency=1),
    tpo.ring(16, link_latency=1),
    tpo.torus3d(4, 2, 2, link_latency=1)], ids=lambda t: f"{t.kind}{t.dims}")
def test_network_latency_equals_compensated_dense_spike_trains(topo):
    """A routed network delivers exactly the spike trains of a network on
    the dense transport whose LUT adds ``latency[src, dest]`` to every
    delay."""
    n, nn = topo.n_chips, 16
    comm = pc.PulseCommConfig(n_chips=n, neurons_per_chip=nn,
                              n_inputs_per_chip=nn, event_capacity=nn,
                              bucket_capacity=nn, ring_depth=16)
    gen = torch.Generator().manual_seed(5)
    table = rt.random_table(gen, nn, n, max_delay=8, min_delay=4)
    tables = rt.RoutingTable(*(x.expand((n,) + x.shape).contiguous()
                               for x in table))
    lat = torch.as_tensor(tpo.compile_routes(topo).latency)
    comp = tables._replace(delay=tables.delay + lat[
        torch.arange(n)[:, None, None], tables.dest_chip.long()])
    cfg_r = net.NetworkConfig(comm=comm, topology=topo)
    cfg_d = net.NetworkConfig(comm=comm)
    params = net.init_params(gen, cfg_r, table=tables, device="cpu")
    ext = 1.5 * (torch.rand((10, n, nn), generator=gen) < 0.4).float()
    _, rec_r = net.run(cfg_r, params, net.init_state(cfg_r, params,
                                                     device="cpu"),
                       ext, device="cpu")
    pd = params._replace(table=comp)
    _, rec_d = net.run(cfg_d, pd, net.init_state(cfg_d, pd, device="cpu"),
                       ext, device="cpu")
    assert int(rec_d.spikes.sum()) > 0
    assert torch.equal(rec_r.spikes, rec_d.spikes)
    assert rec_r.stats.link_words.shape == (10, n, topo.n_ports)


def test_network_over_switch_tree_matches_jax():
    """``NetworkConfig(topology=switch_tree)`` at B 2, bitwise JAX's:
    spikes, ring and every integer stat (voltages within 1e-5)."""
    n, nn, b = 8, 16, 2
    jtopo = jtp.switch_tree(2, 4, link_latency=1, trunk_latency=1)
    comm_kw = dict(n_chips=n, neurons_per_chip=nn, n_inputs_per_chip=nn,
                   event_capacity=nn, bucket_capacity=8, buckets_per_chip=2,
                   mode="full", merge_rate=4, ring_depth=20, superstep=b)
    jcfg = jnet.NetworkConfig(comm=jpc.PulseCommConfig(**comm_kw),
                              topology=jtopo)
    cfg = net.NetworkConfig(comm=pc.PulseCommConfig(**comm_kw),
                            topology=convert.topology_from_jax(jtopo))
    _, _, jtable, _, _ = fabric_setup(n, n_neurons=nn, min_delay=5,
                                      max_delay=10, seed=3)
    jparams = jnet.init_params(jax.random.PRNGKey(3), jcfg, table=jtable)
    rng = np.random.default_rng(3)
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
    assert int(rec.stats.link_words.sum()) > 0 and int(rec.spikes.sum()) > 0


def test_topology_from_jax_recurses_into_the_pod_graph():
    jtopo = jtp.pod(jtp.torus2d(2, 3, link_latency=2, link_bandwidth=4), 3,
                    link_latency=1, link_credits=5)
    topo = convert.topology_from_jax(jtopo)
    assert topo == tpo.pod(tpo.torus2d(2, 3, link_latency=2,
                                       link_bandwidth=4), 3,
                           link_latency=1, link_credits=5)
    assert isinstance(topo.pod_graph, tpo.Topology)
