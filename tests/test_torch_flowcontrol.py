"""Port parity, credit flow control and the send queue: ``repro_torch.
core.flowcontrol`` and ``PulseFabric(flow=FlowControlConfig(...))`` /
``NetworkConfig(flow=...)`` against the JAX package on the CPU, from
inputs made with numpy.

Tolerances: credit counters, send queues, delay rings, delivered words
and every integer ``CommStats`` field bitwise, step by step; the f32
``utilization`` within 1 ulp.  With flow control the inject phase runs
substep by substep at any fan-out (one ``bucket_pack`` launch per
substep on the card), also at fan-out 1 where ``fused_inject`` runs
otherwise.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import delays as jdl  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import fabric as jfb  # noqa: E402
from repro.core import flowcontrol as jfc  # noqa: E402
from repro.core import pulse_comm as jpc  # noqa: E402
from repro.core import routing as jrt  # noqa: E402
from repro.snn import network as jnet  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import delays as dl  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import fabric as fb  # noqa: E402
from repro_torch.core import flowcontrol as fc  # noqa: E402
from repro_torch.core import pulse_comm as pc  # noqa: E402
from repro_torch.core import routing as rt  # noqa: E402
from repro_torch.snn import network as net  # noqa: E402

LEGS = ("sent", "overflow", "expired", "stalled", "merge_dropped")


def same(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=msg)


def same_tuple(want, got, msg=""):
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f == "utilization":
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            np.testing.assert_array_equal(w, g, err_msg=f"{msg} {f}")


# -- the ring protocol --------------------------------------------------------

@given(st.integers(1, 32),
       st.lists(st.tuples(st.booleans(), st.integers(0, 20)), min_size=1,
                max_size=60))
def test_ring_invariants(capacity, ops):
    """Never overwrite an unconsumed slot, FIFO conservation,
    back-pressure; and every counter equals the JAX protocol's."""
    state, jstate = fc.init(capacity), jfc.init(capacity)
    produced = consumed = 0
    for is_produce, n in ops:
        if is_produce:
            state, acc = fc.produce(state, n)
            jstate, jacc = jfc.produce(jstate, n)
            produced += int(acc)
        else:
            state, acc = fc.consume(state, n)
            jstate, jacc = jfc.consume(jstate, n)
            consumed += int(acc)
        assert int(acc) == int(jacc) and int(acc) <= n
        same_tuple(jstate, state)
        outstanding = int(state.head - state.tail)
        assert 0 <= outstanding <= capacity
        assert int(fc.credits(state)) == capacity - outstanding
        assert (produced, consumed) == (int(state.head), int(state.tail))


def test_backpressure_stalls_producer():
    state = fc.init(4)
    state, acc = fc.produce(state, 10)
    assert int(acc) == 4          # ring full
    state, acc = fc.produce(state, 1)
    assert int(acc) == 0          # stalled
    state, got = fc.consume(state, 2)
    assert int(got) == 2 and int(state.notifications) == 1
    state, acc = fc.produce(state, 10)
    assert int(acc) == 2


def test_counters_are_batched_over_chips():
    """One ring per chip: ``[n_chips]`` counters, each chip granted its own
    credits, as JAX's vmapped protocol."""
    want = jnp.asarray([5, 0, 2], jnp.int32)
    jstate, _ = jax.vmap(jfc.produce)(
        jax.vmap(lambda _: jfc.init(3))(jnp.arange(3)), want)
    state, acc = fc.produce(fc.init(3, batch_shape=(3,)), torch.tensor(
        [5, 0, 2], dtype=torch.int32))
    assert acc.tolist() == [3, 0, 2]
    same_tuple(jstate, state)
    q = fc.sendq_init(6, batch_shape=(3,))
    assert q.words.shape == (3, 6) and q.occupancy().tolist() == [0, 0, 0]


def test_slot_indices_wrap_and_mask():
    state = fc.init(4)
    state, _ = fc.produce(state, 3)
    state, _ = fc.consume(state, 3)
    idx, mask = fc.slot_indices(state, 3, producer=True)
    assert idx.tolist() == [3, 0, 1] and mask.tolist() == [True] * 3
    idx, mask = fc.slot_indices(fc.init(4), 3, count=torch.tensor(2),
                                producer=True)
    assert idx.tolist() == [0, 1, 2]
    assert mask.tolist() == [True, True, False]
    with pytest.raises(TypeError, match="int"):
        fc.slot_indices(state, torch.tensor(3), producer=True)


# -- the credit gate in the fabric --------------------------------------------

def _setup(n_chips=4, n=64, cap=4, *, bpc=2, mode="simplified", b=1,
           fanout=1, p=0.9, steps=1, seed=1, min_delay=1, max_delay=8):
    """Both configs, the LUT and ``steps`` blocks of events ``[B,
    n_chips, E]`` at clocks 0, B, 2B, ... (numpy)."""
    kw = dict(n_chips=n_chips, neurons_per_chip=n, n_inputs_per_chip=n,
              event_capacity=n, fanout=fanout, bucket_capacity=cap,
              buckets_per_chip=bpc, ring_depth=16, mode=mode, superstep=b)
    rng = np.random.default_rng(seed)
    shape = (n_chips, n, fanout)
    table = rt.RoutingTable(
        dest_chip=torch.as_tensor(rng.integers(0, n_chips, shape),
                                  dtype=torch.int32),
        dest_addr=torch.as_tensor(rng.integers(0, n, shape),
                                  dtype=torch.int32),
        delay=torch.as_tensor(rng.integers(min_delay, max_delay + 1, shape),
                              dtype=torch.int32),
        valid=torch.ones(shape, dtype=torch.bool))
    spikes = torch.as_tensor(rng.random((steps * b, n_chips, n)) < p)
    blocks = []
    for s in range(steps):
        bufs = [ev.from_spikes(spikes[s * b + k], s * b + k, n)[0]
                for k in range(b)]
        blocks.append(ev.EventBuffer(*(torch.stack(x) for x in zip(*bufs))))
    return pc.PulseCommConfig(**kw), table, blocks


class Both:
    """The port's fabric and JAX's, driven block by block on the same
    inputs and held equal after every block; keeps run totals."""

    def __init__(self, cfg, table, flow):
        jcfg = jpc.PulseCommConfig(**dataclasses.asdict(cfg))
        jflow = None if flow is None else jfb.FlowControlConfig(
            **dataclasses.asdict(flow))
        self.fab = fb.PulseFabric(cfg, device="cpu", flow=flow)
        self.jfab = jfb.PulseFabric(jcfg, transport="local", flow=jflow)
        self.jrun = self.jfab.jit_superstep()
        self.table = table
        self.jtable = jrt.RoutingTable(*(jnp.asarray(x.numpy())
                                         for x in table))
        self.ring = dl.init(16, cfg.n_inputs_per_chip,
                            batch_shape=(cfg.n_chips,))
        self.jring = jax.vmap(lambda _: jdl.init(16, cfg.n_inputs_per_chip))(
            jnp.arange(cfg.n_chips))
        self.carry = self.fab._init_missing(None, None, None)
        self.jcarry = self.jfab._init_missing(None, None, None)
        self.tot = dict.fromkeys(LEGS, 0)
        self.b = cfg.superstep

    def block(self, events):
        jres = self.jrun(jev.EventBuffer(*(jnp.asarray(x.numpy())
                                           for x in events)),
                         self.jtable, self.jring, *self.jcarry)
        res = self.fab.superstep(events, self.table, self.ring, *self.carry)
        same(jres.ring.ring, res.ring.ring, "ring")
        same(jres.delivered.words, res.delivered.words, "words")
        same_tuple(jres.stats, res.stats, "stats")
        for name in ("flow", "sendq"):
            if getattr(jres, name) is not None:
                same_tuple(getattr(jres, name), getattr(res, name), name)
        self.carry = (res.flow, res.merge, res.sendq)
        self.jcarry = (jres.flow, jres.merge, jres.sendq)
        # the clock advances so queued deadlines age
        self.ring = dl.DelayRing(res.ring.ring, res.ring.now + self.b)
        self.jring = jdl.DelayRing(jres.ring.ring, jres.ring.now + self.b)
        for f in LEGS:
            self.tot[f] += int(getattr(res.stats, f).sum())
        return res

    def queued(self) -> int:
        sendq = self.carry[2]
        return 0 if sendq is None else int(sendq.occupancy().sum())

    def conserves(self) -> bool:
        """Σ sent == deposits + expired + overflow + merge_dropped +
        stalled + the send queue's occupancy."""
        t = self.tot
        return t["sent"] == (int(self.ring.ring.sum()) + t["expired"]
                             + t["overflow"] + t["merge_dropped"]
                             + t["stalled"] + self.queued())


@pytest.mark.parametrize("fanout", [1, 3])
def test_flow_control_conserves_events(fanout):
    """Tight credits stall, the gate holds events back with accounting
    (the per-substep loop, also at fan-out 1)."""
    cfg, table, blocks = _setup(fanout=fanout)
    both = Both(cfg, table, fb.FlowControlConfig(capacity=2, drain_rate=1))
    both.block(blocks[0])
    assert both.tot["stalled"] > 0
    assert both.conserves()


def test_flow_control_credits_thread_across_steps():
    """At most ``capacity`` packets are in flight, and the consumer returns
    credits by notifications."""
    cfg, table, blocks = _setup(n=32, bpc=4)
    flow = fb.FlowControlConfig(capacity=3, drain_rate=1)
    both = Both(cfg, table, flow)
    for _ in range(4):
        res = both.block(blocks[0])
        in_flight = res.flow.head - res.flow.tail
        assert bool(((in_flight >= 0) & (in_flight <= flow.capacity)).all())
    assert bool((res.flow.notifications > 0).all())


@pytest.mark.parametrize("depth", [0, 32])
def test_ample_credits_match_no_flow_bitwise(depth):
    cfg, table, blocks = _setup(n=32, cap=8, mode="full", p=0.4)
    ring = dl.init(16, 32, batch_shape=(4,))
    base = fb.PulseFabric(cfg, device="cpu").step(
        ev.EventBuffer(*(x[0] for x in blocks[0])), table, ring)
    ample = fb.PulseFabric(cfg, device="cpu", flow=fb.FlowControlConfig(
        capacity=cfg.n_buckets + 1, drain_rate=cfg.n_buckets + 1,
        retransmit_depth=depth)).step(
            ev.EventBuffer(*(x[0] for x in blocks[0])), table, ring)
    assert torch.equal(ample.ring.ring, base.ring.ring)
    assert torch.equal(ample.delivered.words, base.delivered.words)
    for f in pc.CommStats._fields:
        assert torch.equal(getattr(ample.stats, f), getattr(base.stats, f))
    assert int(ample.stats.stalled.sum()) == 0
    if depth:
        assert int(ample.sendq.occupancy().sum()) == 0


def _burst(flow, steps=12, fanout=1):
    """One burst through the credits, then empty steps, against JAX."""
    cfg, table, blocks = _setup(fanout=fanout)
    idle = ev.EventBuffer(*(torch.zeros_like(x) for x in blocks[0]))
    both = Both(cfg, table, flow)
    for t in range(steps):
        both.block(blocks[0] if t == 0 else idle)
    return both


@pytest.mark.parametrize("fanout", [1, 3])
def test_retransmit_requeues_instead_of_dropping(fanout):
    """A roomy send queue re-offers credit-stalled words on later steps:
    no stalled drop, the queue drains, conservation holds, and more is
    delivered or judged than by the drop-and-account gate."""
    both = _burst(fb.FlowControlConfig(capacity=2, drain_rate=1,
                                       retransmit_depth=128), fanout=fanout)
    assert both.tot["stalled"] == 0 and both.queued() == 0
    assert both.conserves()
    dropped = _burst(fb.FlowControlConfig(capacity=2, drain_rate=1),
                     fanout=fanout)
    assert dropped.tot["stalled"] > 0 and dropped.conserves()
    assert (int(both.ring.ring.sum()) + both.tot["expired"]
            > int(dropped.ring.ring.sum()) + dropped.tot["expired"])


def test_retransmit_bounded_queue_overflow_is_accounted():
    both = _burst(fb.FlowControlConfig(capacity=1, drain_rate=1,
                                       retransmit_depth=4))
    assert both.tot["stalled"] > 0
    assert both.conserves()


def test_retransmit_queued_events_expire_when_stalled_too_long():
    """Starved of credits, a queued word is judged against the window
    every step and lands in ``expired``, never on the wire."""
    both = _burst(fb.FlowControlConfig(capacity=0, drain_rate=0,
                                       retransmit_depth=512), steps=24)
    assert both.queued() == 0 and int(both.ring.ring.sum()) == 0
    assert both.tot["expired"] > 0
    assert both.conserves()


@pytest.mark.parametrize("fanout", [1, 2])
def test_flow_control_with_sendq_conserves_under_superstep(fanout):
    """B 2: the gate's credits and the queue thread across the substeps
    of a block and across blocks (the per-substep loop)."""
    cfg, table, blocks = _setup(n=32, cap=8, b=2, fanout=fanout, steps=4,
                                min_delay=8, max_delay=12)
    both = Both(cfg, table, fb.FlowControlConfig(capacity=2, drain_rate=1,
                                                 retransmit_depth=64))
    for blk in blocks:
        both.block(blk)
    assert both.tot["sent"] > 0 and both.queued() > 0
    assert both.conserves()


def test_network_threads_credit_state_across_steps():
    """The credit state rides in ``NetworkState.flow``: ``run`` and
    repeated ``step`` calls accumulate back-pressure, as JAX's do."""
    kw = dict(n_chips=2, neurons_per_chip=16, n_inputs_per_chip=16,
              event_capacity=16, bucket_capacity=4, buckets_per_chip=4,
              ring_depth=8)
    flow = fb.FlowControlConfig(capacity=2, drain_rate=1)
    cfg = net.NetworkConfig(comm=pc.PulseCommConfig(**kw), flow=flow)
    jcfg = jnet.NetworkConfig(comm=jpc.PulseCommConfig(**kw),
                              flow=jfb.FlowControlConfig(capacity=2,
                                                         drain_rate=1))
    jparams = jnet.init_params(jax.random.PRNGKey(0), jcfg)
    # its weights on a dyadic grid: crossbar sums exact in any order
    w = jnp.round(jparams.crossbar.w * 64) / 64
    jparams = jparams._replace(crossbar=jparams.crossbar._replace(w=w))
    params = convert.params_from_jax(jparams, device="cpu")
    state = net.init_state(cfg, params, device="cpu")
    assert state.flow is not None and state.flow.head.shape == (2,)
    ext = np.ones((6, 2, 16), np.float32)
    jfinal, jrec = jax.jit(lambda p, s, e: jnet.run(jcfg, p, s, e))(
        jparams, jnet.init_state(jcfg, jparams), jnp.asarray(ext))
    final, rec = net.run(cfg, params, state, ext, device="cpu")
    same(jrec.spikes, rec.spikes, "spikes")
    same_tuple(jrec.stats, rec.stats, "stats")
    same_tuple(jfinal.flow, final.flow, "flow")
    in_flight = final.flow.head - final.flow.tail
    assert bool(((in_flight >= 0) & (in_flight <= 2)).all())
    assert int(rec.stats.stalled.sum()) > 0
    s1, _ = net.step(cfg, params, state, ext[0], device="cpu")
    s2, _ = net.step(cfg, params, s1, ext[1], device="cpu")
    assert int(s2.flow.tail.sum()) >= int(s1.flow.tail.sum())
    s2r, _ = net.run(cfg, params, state, ext[:2], device="cpu")
    same_tuple(s2r.flow, s2.flow, "two steps against a two-step run")
