"""Port parity, source and destination stages: bucket packing, the delay
ring and the merge of ``repro_torch.core`` against the JAX package,
bitwise, on the CPU.

Pins the ranking and scatter rules of the reference pack (bucket ids
outside ``[0, n_buckets)``, negative ids wrapping once, the later lane
winning a shared cell), jnp's floor ``//`` and ``%`` in the bucket window
and the ring slot, the deposit window with ``min_ahead``, and the stable
merge with its rate-limited queue.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import buckets as jbk  # noqa: E402
from repro.core import delays as jdl  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import merge as jmg  # noqa: E402
from repro.core import pulse_comm as jpc  # noqa: E402
from repro_torch.core import buckets as bk  # noqa: E402
from repro_torch.core import delays as dl  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import merge as mg  # noqa: E402
from repro_torch.core import pulse_comm as pc  # noqa: E402


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def same(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=msg)


def _lanes(seed, e, nb, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    bid = rng.integers(lo, nb if hi is None else hi, e).astype(np.int32)
    addr = rng.integers(0, 1 << 14, e).astype(np.int32)
    dead = rng.integers(-20, 300, e).astype(np.int32)
    valid = rng.random(e) < 0.75
    return bid, addr, dead, valid


@pytest.mark.parametrize("lo,hi", [(0, 6), (-9, 11)])
def test_compute_slots_matches_reference(lo, hi):
    bid, _, _, valid = _lanes(1, 48, 6, lo, hi)
    want_slot, want_counts = jbk.compute_slots(jnp.asarray(bid),
                                               jnp.asarray(valid), 6)
    slot, counts = bk.compute_slots(T(bid), T(valid), 6)
    same(want_slot, slot, "slot")
    same(want_counts, counts, "counts")


@pytest.mark.parametrize("seed,lo,hi,cap", [
    (2, 0, 5, 8),       # in range
    (3, 0, 5, 3),       # overflow past the capacity
    (4, -7, 9, 4),      # negative ids wrap once, far ids drop
    (5, -1, 2, 16),     # wrapped words share cells: the later lane wins
])
def test_pack_matches_reference(seed, lo, hi, cap):
    bid, addr, dead, valid = _lanes(seed, 40, 5, lo, hi)
    want = jbk.pack(*map(jnp.asarray, (bid, addr, dead, valid)),
                    n_buckets=5, capacity=cap, slots="onehot")
    got = bk.pack(T(bid), T(addr), T(dead), T(valid), n_buckets=5,
                  capacity=cap)
    same(want.words, got.words, "words")
    same(want.counts, got.counts, "counts")
    same(want.overflow, got.overflow, "overflow")


def test_flush_pack_keeps_untouched_cells_of_its_column():
    bid, addr, dead, valid = _lanes(6, 30, 4, -2, 5)
    rng = np.random.default_rng(6)
    slab = rng.integers(-1, 1 << 20, (4, 3, 5)).astype(np.int32)
    want = jbk.flush_pack(*map(jnp.asarray, (bid, addr, dead, valid)),
                          slab=jnp.asarray(slab), capacity=5, substep=1,
                          slots="onehot")
    got = bk.flush_pack(T(bid), T(addr), T(dead), T(valid), slab=T(slab),
                        capacity=5, substep=1)
    for w, g, name in zip(want, got, ("slab", "counts", "overflow")):
        same(w, g, name)


def test_bucket_ids_floor_on_negative_deadlines():
    dest = np.array([0, 1, 2, 3, 1, 0, -1], np.int32)
    dead = np.array([-9, -4, -1, 0, 3, 7, 5], np.int32)
    same(jbk.dynamic_bucket_ids(jnp.asarray(dest), jnp.asarray(dead),
                                n_chips=4, pool_per_chip=3, window=4),
         bk.dynamic_bucket_ids(T(dest), T(dead), n_chips=4, pool_per_chip=3,
                               window=4))
    same(jbk.static_bucket_ids(jnp.asarray(dest), n_chips=4, streams=2),
         bk.static_bucket_ids(T(dest), n_chips=4, streams=2))


def _words(rng, shape, now, spread, p):
    addr = rng.integers(0, 40, shape)
    dead = np.asarray(now)[..., None] + rng.integers(-6, spread, shape)
    valid = rng.random(shape) < p
    return np.asarray(jev.encode_word(addr, dead, valid))


@pytest.mark.parametrize("min_ahead", [0, 3])
def test_deposit_words_matches_reference(min_ahead):
    rng = np.random.default_rng(min_ahead)
    now = np.array([0, 250, 255, 1000], np.int32)
    ring = rng.integers(0, 3, (4, 12, 30)).astype(np.int32)
    words = _words(rng, (4, 50), now, 30, 0.8)
    jring = jdl.DelayRing(ring=jnp.asarray(ring), now=jnp.asarray(now))
    want, want_exp = jax.vmap(
        lambda r, w: jdl.deposit_words(r, w, min_ahead=min_ahead))(
        jring, jnp.asarray(words))
    got, exp = dl.deposit_words(dl.DelayRing(T(ring), T(now)), T(words),
                                min_ahead=min_ahead)
    same(want.ring, got.ring, "ring")
    same(want_exp, exp, "expired")
    # pop and tick on the deposited ring
    want_r, want_s = jax.vmap(jdl.pop_current)(want)
    got_r, got_s = dl.pop_current(got)
    same(want_s, got_s, "popped spikes")
    same(want_r.ring, got_r.ring, "ring after pop")
    same(jax.vmap(jdl.tick)(want_r).now, dl.tick(got_r).now, "tick")


@pytest.mark.parametrize("now", [[0, 3], [250, 255]])
def test_merge_words_stable_across_the_wrap(now):
    rng = np.random.default_rng(now[0])
    now = np.array(now, np.int32)
    words = _words(rng, (2, 64), now, 12, 0.7)   # many equal keys
    want = jax.vmap(jmg.merge_words)(jnp.asarray(words), jnp.asarray(now))
    same(want, mg.merge_words(T(words), T(now)))


def test_merge_split_matches_reference():
    rng = np.random.default_rng(9)
    srt = np.sort(_words(rng, (40,), np.int32(0), 10, 0.6))[::-1].copy()
    for w, g, name in zip(jmg.merge_split(jnp.asarray(srt), rate=5, depth=8),
                          mg.merge_split(T(srt), rate=5, depth=8),
                          ("queue", "emitted", "dropped")):
        same(w, g, name)


@pytest.mark.parametrize("b,queue_full", [(1, False), (4, True)])
def test_merge_drain_words_matches_reference(b, queue_full):
    rng = np.random.default_rng(b)
    n_chips, depth, rate = 3, 8, 3
    now0 = np.array([0, 120, 253], np.int32)
    queue = _words(rng, (n_chips, depth), now0, 10,
                   1.0 if queue_full else 0.4)
    incoming = np.stack([_words(rng, (n_chips, 12), now0 + k, 20, 0.6)
                         for k in range(b)])
    want_buf, want_out, want_drop = jax.vmap(
        lambda q, w, t: jmg.merge_drain_words(jmg.MergeBuffer(words=q), w,
                                              now0=t, rate=rate),
        in_axes=(0, 1, 0))(jnp.asarray(queue), jnp.asarray(incoming),
                           jnp.asarray(now0))
    buf, out, drop = mg.merge_drain_words(mg.MergeBuffer(words=T(queue)),
                                          T(incoming), now0=T(now0),
                                          rate=rate)
    same(want_buf.words, buf.words, "queue")
    same(np.swapaxes(np.asarray(want_out), 0, 1), out, "emitted")
    same(np.swapaxes(np.asarray(want_drop), 0, 1), drop, "dropped")
    if queue_full:
        assert int(drop.sum()) > 0


@pytest.mark.parametrize("kw", [
    dict(mode="bogus"),
    dict(superstep=0),
    dict(superstep=8, ring_depth=120),
    dict(neurons_per_chip=(1 << 14) + 1),
    dict(n_inputs_per_chip=(1 << 14) + 1),
    dict(mode="full", merge_rate=1, merge_depth=200),
    dict(ring_depth=128),
])
def test_config_guards_match_reference(kw):
    with pytest.raises(ValueError):
        jpc.PulseCommConfig(n_chips=2, **kw)
    with pytest.raises(ValueError):
        pc.PulseCommConfig(n_chips=2, **kw)


def test_config_derived_sizes_match_reference():
    kw = dict(n_chips=5, buckets_per_chip=3, bucket_capacity=7)
    j, t = jpc.PulseCommConfig(**kw), pc.PulseCommConfig(**kw)
    assert (j.n_buckets, j.lanes_in) == (t.n_buckets, t.lanes_in)
