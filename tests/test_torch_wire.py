"""Port parity, wire layer: events, routing and the local exchange of
``repro_torch`` against the JAX package, bitwise, on the CPU.

Covers the edge rules a port gets wrong first: word 0 is a valid event,
negative and out-of-range LUT addresses (JAX wraps a negative index once,
then clamps), negative and out-of-range destinations in the traffic
matrix, and ``from_spikes`` at and over its capacity.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import events as jev  # noqa: E402
from repro.core import pulse_comm as jpc  # noqa: E402
from repro.core import routing as jrt  # noqa: E402
from repro.core import transport as jtp  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import pulse_comm as pc  # noqa: E402
from repro_torch.core import routing as rt  # noqa: E402
from repro_torch.core import transport as tp  # noqa: E402


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def same(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=msg)


@pytest.mark.parametrize("now", [0, 5, 127, 128, 250, 255, 1000003, -7])
def test_word_codec_matches_reference(now):
    rng = np.random.default_rng(now & 0xFFFF)
    addr = np.concatenate([[0, 0, 16383, 16384, 20000, -1],
                           rng.integers(-5, 1 << 15, 58)]).astype(np.int32)
    time = np.concatenate([[0, 255, 256, -1, now, now + 127],
                           now + rng.integers(-300, 300, 58)]).astype(np.int32)
    valid = np.concatenate([[True] * 6, rng.random(58) < 0.7])
    jw = jev.encode_word(addr, time, valid)
    w = ev.encode_word(T(addr), T(time), T(valid))
    same(jw, w, "encode_word")
    for name in ("word_addr", "word_time", "word_valid"):
        same(getattr(jev, name)(jw), getattr(ev, name)(w), name)
    same(jev.word_sort_key(jw, jnp.int32(now)), ev.word_sort_key(w, now),
         "word_sort_key")
    same(jev.word_deadline(jw, jnp.int32(now)), ev.word_deadline(w, now),
         "word_deadline")
    same(jev.wrap8(time), ev.wrap8(T(time)), "wrap8")
    same(jev.wrap8_diff(time, np.int32(now)),
         ev.wrap8_diff(T(time), torch.tensor(now, dtype=torch.int32)),
         "wrap8_diff")


def test_word_zero_is_a_valid_event():
    w = ev.encode_word(T([0]), T([0]), T([True]))
    assert int(w[0]) == 0
    assert bool(ev.word_valid(w)[0])
    assert int(ev.word_addr(w)[0]) == 0
    assert not bool(ev.word_valid(T([ev.WORD_SENTINEL]))[0])


@pytest.mark.parametrize("n,capacity,density", [
    (32, 8, 0.6),      # over capacity: the surplus is cut
    (32, 32, 1.0),     # every neuron fires, exactly at capacity
    (16, 24, 0.5),     # capacity above the population: sentinel padding
    (8, 4, 0.0),       # nothing fires
])
def test_from_spikes_matches_reference(n, capacity, density):
    rng = np.random.default_rng(n * capacity)
    spikes = rng.random((3, n)) < density
    t = 41
    jeb, jdrop = jax.vmap(lambda s: jev.from_spikes(s, t, capacity))(
        jnp.asarray(spikes))
    eb, drop = ev.from_spikes(T(spikes), t, capacity)
    for f in ("addr", "time", "valid"):
        same(getattr(jeb, f), getattr(eb, f), f)
    same(jdrop, drop, "dropped")


def _table(rng, n_chips, n, k, lo_chip=0):
    return jrt.RoutingTable(
        dest_chip=jnp.asarray(rng.integers(lo_chip, n_chips, (n_chips, n, k)),
                              jnp.int32),
        dest_addr=jnp.asarray(rng.integers(0, n, (n_chips, n, k)), jnp.int32),
        delay=jnp.asarray(rng.integers(1, 12, (n_chips, n, k)), jnp.int32),
        valid=jnp.asarray(rng.random((n_chips, n, k)) < 0.8))


def _torch_table(jtable):
    return rt.RoutingTable(*(T(x) for x in jtable))


@pytest.mark.parametrize("k", [1, 3])
def test_route_matches_reference_on_edge_addresses(k):
    rng = np.random.default_rng(k)
    n_chips, n, e = 3, 20, 16
    jtable = _table(rng, n_chips, n, k)
    addr = rng.integers(0, n, (n_chips, e))
    # negative addresses wrap once (-1 -> n-1), then clamp; past the end
    # clamps to n-1
    addr[:, :6] = [-1, -n, -n - 5, n, n + 7, 0]
    addr = addr.astype(np.int32)
    time = rng.integers(0, 300, (n_chips, e)).astype(np.int32)
    valid = rng.random((n_chips, e)) < 0.8
    jeb = jev.EventBuffer(addr=jnp.asarray(addr), time=jnp.asarray(time),
                          valid=jnp.asarray(valid))
    want = jax.vmap(jrt.route)(jeb, jtable)
    got = rt.route(ev.EventBuffer(T(addr), T(time), T(valid)),
                   _torch_table(jtable))
    for f in want._fields:
        same(getattr(want, f), getattr(got, f), f)


def test_route_broadcasts_a_block_over_chip_tables():
    rng = np.random.default_rng(7)
    b, n_chips, n, e = 4, 3, 12, 10
    jtable = _table(rng, n_chips, n, 2)
    addr = rng.integers(-3, n + 3, (b, n_chips, e)).astype(np.int32)
    time = rng.integers(0, 50, (b, n_chips, e)).astype(np.int32)
    valid = rng.random((b, n_chips, e)) < 0.7
    got = rt.route(ev.EventBuffer(T(addr), T(time), T(valid)),
                   _torch_table(jtable))
    for k in range(b):
        jeb = jev.EventBuffer(addr=jnp.asarray(addr[k]),
                              time=jnp.asarray(time[k]),
                              valid=jnp.asarray(valid[k]))
        want = jax.vmap(jrt.route)(jeb, jtable)
        for f in want._fields:
            same(getattr(want, f), getattr(got, f)[k], f"{f} substep {k}")


def test_exchange_matrix_drops_negative_and_far_destinations():
    rng = np.random.default_rng(3)
    dest = rng.integers(-6, 9, (5, 40)).astype(np.int32)
    valid = rng.random((5, 40)) < 0.8
    want = jax.vmap(lambda d, v: jtp.exchange_matrix(d, v, 4))(
        jnp.asarray(dest), jnp.asarray(valid))
    same(want, tp.exchange_matrix(T(dest), T(valid), 4))


@pytest.mark.parametrize("b,bpc", [(1, 1), (4, 2)])
def test_local_exchange_matches_vmapped_all_to_all(b, bpc):
    n_chips, cap = 3, 4
    cfg_kw = dict(n_chips=n_chips, neurons_per_chip=16, n_inputs_per_chip=16,
                  bucket_capacity=cap, buckets_per_chip=bpc, superstep=b)
    jcfg, cfg = jpc.PulseCommConfig(**cfg_kw), pc.PulseCommConfig(**cfg_kw)
    rng = np.random.default_rng(b * bpc)
    slab = rng.integers(0, 1 << 22, (n_chips, n_chips * bpc, b, cap))
    slab = np.where(rng.random(slab.shape) < 0.5, slab, -1).astype(np.int32)
    transport = jtp.ShardMapTransport(axis="x", n_chips=n_chips)
    want, want_link = jax.vmap(
        lambda s: jpc.exchange_flush(jcfg, transport, s), axis_name="x")(
        jnp.asarray(slab))
    got, link = pc.exchange_flush(cfg, T(slab))
    same(want, got, "delivered words")
    same(want_link.words, link.words, "link words")
    same(want_link.backlog, link.backlog, "link backlog")


def test_feedforward_table_matches_reference():
    want = jrt.feedforward_table(10, src_chip=0, dst_chip=1, delay=3,
                                 remap_offset=4)
    got = rt.feedforward_table(10, src_chip=0, dst_chip=1, delay=3,
                               remap_offset=4)
    for f in want._fields:
        same(getattr(want, f), getattr(got, f), f)


def test_random_table_draws_inside_its_bounds():
    gen = torch.Generator().manual_seed(5)
    t = rt.random_table(gen, 50, 6, fanout=3, min_delay=4, max_delay=9,
                        p_valid=0.5)
    assert t.dest_chip.shape == (50, 3) and t.dest_chip.dtype == torch.int32
    assert int(t.dest_chip.min()) >= 0 and int(t.dest_chip.max()) < 6
    assert int(t.dest_addr.min()) >= 0 and int(t.dest_addr.max()) < 50
    assert int(t.delay.min()) >= 4 and int(t.delay.max()) <= 9
    assert 0 < int(t.valid.sum()) < 150
    again = rt.random_table(torch.Generator().manual_seed(5), 50, 6,
                            fanout=3, min_delay=4, max_delay=9, p_valid=0.5)
    for a, b in zip(t, again):
        assert torch.equal(a, b)
