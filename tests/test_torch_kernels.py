"""Port parity, kernels: the plain PyTorch versions of ``fused_inject``,
``bucket_pack`` and ``fused_drain`` against the JAX package's ``ref.py``
oracles and its Pallas kernels in interpret mode, bitwise, on the CPU.

On the CPU each port wrapper runs its plain version (the CUDA kernels run
only on a card, where ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
hold them against the same plain versions).  Cases:
simplified and full mode, negative and out-of-range bucket ids, bucket
overflow, deadlines outside the admission window, every drain mode with
the gate on, off and mixed, and B in {1, 4}.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import delays as jdl  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import routing as jrt  # noqa: E402
from repro.kernels.bucket_pack import ops as jbp  # noqa: E402
from repro.kernels.bucket_pack.ref import bucket_pack_ref as jbp_ref  # noqa: E402
from repro.kernels.fused_drain import ops as jfd  # noqa: E402
from repro.kernels.fused_drain.ref import fused_drain_ref as jfd_ref  # noqa: E402
from repro.kernels.fused_inject import ops as jfi  # noqa: E402
from repro.kernels.fused_inject.ref import fused_inject_ref as jfi_ref  # noqa: E402
from repro_torch.core import delays as dl  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import routing as rt  # noqa: E402
from repro_torch.kernels import common as kc  # noqa: E402
from repro_torch.kernels.bucket_pack import ops as bp  # noqa: E402
from repro_torch.kernels.fused_drain import ops as fd  # noqa: E402
from repro_torch.kernels.fused_inject import ops as fi  # noqa: E402

N_CHIPS = 3


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def same(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=msg)


# ---------------------------------------------------------------------------
# fused_inject
# ---------------------------------------------------------------------------

def _inject_case(b, case, seed=0):
    """Event block [B, n_chips, E] with negative and out-of-range source
    addresses, per-chip clocks across the 255 -> 0 wrap, and a fan-out-1
    LUT per chip.  ``tight`` forces bucket overflow, ``far`` puts delays
    outside the admission window, ``negative`` routes to dest chips -2 and
    -1, ``wrapped`` every entry to -1 (every admitted lane's bucket wraps,
    and lanes collide on cells)."""
    rng = np.random.default_rng(seed + 10 * b + len(case))
    n, e = 24, 20
    t0 = np.array([0, 120, 250], np.int32)
    addr = rng.integers(-3, n + 3, (b, N_CHIPS, e)).astype(np.int32)
    time = (t0[None, :, None]
            + rng.integers(0, b + 1, (b, N_CHIPS, e))).astype(np.int32)
    valid = rng.random((b, N_CHIPS, e)) < 0.7
    lo = -2 if case == "negative" else 0
    dest = rng.integers(lo, N_CHIPS, (N_CHIPS, n, 1))
    if case == "wrapped":
        dest[:] = -1
    if case == "far":
        delay = rng.choice([-3, 0, 1, 2, 127, 128, 200], (N_CHIPS, n, 1))
    else:
        delay = rng.integers(max(1, b), 13, (N_CHIPS, n, 1))
    table = jrt.RoutingTable(
        dest_chip=jnp.asarray(dest, jnp.int32),
        dest_addr=jnp.asarray(rng.integers(0, n, (N_CHIPS, n, 1)), jnp.int32),
        delay=jnp.asarray(delay, jnp.int32),
        valid=jnp.asarray(rng.random((N_CHIPS, n, 1)) < 0.9))
    cap = 2 if case == "tight" else 8
    return (addr, time, valid), table, t0, cap


def _jax_inject(fn, events, table, t0, kw):
    jeb = jev.EventBuffer(*map(jnp.asarray, events))
    return jax.vmap(lambda e, tb, t: fn(e, tb, None, t, **kw),
                    in_axes=(1, 0, 0))(jeb, table, jnp.asarray(t0))


def _check_inject(want, got):
    same(want.slab, got.slab, "slab")
    for f in ("counts", "sent", "overflow", "wrap_expired", "traffic"):
        same(np.swapaxes(np.asarray(getattr(want, f)), 0, 1),
             getattr(got, f), f)


@pytest.mark.parametrize("case", ["random", "tight", "far", "negative",
                                  "wrapped"])
@pytest.mark.parametrize("mode", ["simplified", "full"])
@pytest.mark.parametrize("b", [1, 4])
def test_fused_inject_plain_matches_reference(b, mode, case):
    events, table, t0, cap = _inject_case(b, case)
    kw = dict(n_chips=N_CHIPS, buckets_per_chip=2, capacity=cap, mode=mode,
              time_window=4)
    want = _jax_inject(jfi_ref, events, table, t0, kw)
    got = fi.fused_inject(ev.EventBuffer(*map(T, events)),
                          rt.RoutingTable(*map(T, table)), T(t0), **kw)
    _check_inject(want, got)
    if case == "tight":
        assert int(got.overflow.sum()) > 0
    if case == "far":
        assert int(got.wrap_expired.sum()) > 0


@pytest.mark.parametrize("mode", ["simplified", "full"])
@pytest.mark.parametrize("b", [1, 4])
def test_fused_inject_plain_matches_pallas_interpret(b, mode):
    """Against the TPU kernel itself, run by the Pallas interpreter (the
    ``negative`` case is left out: where wrapped words share a cell the
    TPU kernel adds them, the reference keeps the later one, and the port
    follows the reference)."""
    events, table, t0, cap = _inject_case(b, "tight", seed=1)
    kw = dict(n_chips=N_CHIPS, buckets_per_chip=2, capacity=cap, mode=mode,
              time_window=4)
    want = _jax_inject(
        lambda *a, **k: jfi.fused_inject(*a, interpret=True, **k),
        events, table, t0, kw)
    got = fi.fused_inject(ev.EventBuffer(*map(T, events)),
                          rt.RoutingTable(*map(T, table)), T(t0), **kw)
    _check_inject(want, got)


def test_fused_inject_rejects_fanout_above_one():
    events, table, t0, _ = _inject_case(1, "random")
    wide = rt.RoutingTable(*(torch.cat([T(x)] * 2, -1) for x in table))
    with pytest.raises(ValueError, match="fanout 1"):
        fi.fused_inject(ev.EventBuffer(*map(T, events)), wide, T(t0),
                        n_chips=N_CHIPS, buckets_per_chip=1, capacity=4)


# ---------------------------------------------------------------------------
# bucket_pack
# ---------------------------------------------------------------------------

def _pack_lanes(seed, shape, lo, hi):
    rng = np.random.default_rng(seed)
    return (rng.integers(lo, hi, shape).astype(np.int32),
            rng.integers(0, 1 << 14, shape).astype(np.int32),
            rng.integers(0, 256, shape).astype(np.int32),
            rng.random(shape) < 0.7)


@pytest.mark.parametrize("cap", [3, 16])
def test_bucket_pack_plain_matches_reference_in_range(cap):
    lanes = _pack_lanes(cap, (2, 60), 0, 6)
    got = bp.bucket_pack(*map(T, lanes), n_buckets=6, capacity=cap)
    for r in range(2):
        want = jbp_ref(*(jnp.asarray(x[r]) for x in lanes), n_buckets=6,
                       capacity=cap)
        same(want.words, got.words[r], "words")
        same(want.counts, got.counts[r], "counts")
        same(want.overflow, got.overflow[r], "overflow")


@pytest.mark.parametrize("lo,hi,cap", [(0, 6, 3), (-4, 9, 4)])
def test_bucket_pack_plain_matches_pallas_interpret(lo, hi, cap):
    """Against the TPU kernel: out-of-range bucket ids belong to no bucket
    (the reference pack would rank them against the clipped bucket)."""
    lanes = _pack_lanes(hi * cap, (50,), lo, hi)
    want = jbp.bucket_pack(*map(jnp.asarray, lanes), n_buckets=6,
                           capacity=cap, interpret=True)
    got = bp.bucket_pack(*map(T, lanes), n_buckets=6, capacity=cap)
    same(want.words, got.words, "words")
    same(want.counts, got.counts, "counts")
    same(want.overflow, got.overflow, "overflow")


def test_flush_pack_block_layout_matches_per_substep_kernel():
    b, n_buckets, cap = 2, 4, 3
    lanes = _pack_lanes(11, (b, N_CHIPS, 24), 0, n_buckets)
    slab, counts, overflow = bp.flush_pack(*map(T, lanes),
                                           n_buckets=n_buckets, capacity=cap)
    assert tuple(slab.shape) == (N_CHIPS, n_buckets, b, cap)
    for c in range(N_CHIPS):
        want = jev.sentinel_words((n_buckets, b, cap))
        for k in range(b):
            want, cnt, ovf = jbp.flush_pack(
                *(jnp.asarray(x[k, c]) for x in lanes), slab=want,
                capacity=cap, substep=k, interpret=True)
            same(cnt, counts[k, c], "counts")
            same(ovf, overflow[k, c], "overflow")
        same(want, slab[c], "slab")


def _block_pack_np(bid, words, nb, cap, threads):
    """The card kernel's arithmetic on ``[rows, L]`` lanes, in numpy: one
    CTA of T = ``threads`` threads per row ranks tile k, the lanes ``[k*T,
    (k+1)*T)``, warp by warp -- a warp's count per bucket, the exclusive
    scan of those counts over the warps, the lane's rank among its warp's
    members of its bucket -- and adds the members of earlier tiles.  -1
    fills ``[count_b, C)``."""
    rows, lanes = bid.shape
    n_warps = threads // 32
    out = np.full((rows, nb, cap), -1, np.int32)
    counts = np.zeros((rows, nb), np.int32)
    lower = np.tri(32, k=-1, dtype=bool)        # lane j < lane i
    for row in range(rows):
        key = np.where((words[row] >= 0) & (bid[row] >= 0) & (bid[row] < nb),
                       bid[row], -1)
        running = np.zeros(nb, np.int64)
        for lo in range(0, lanes, threads):
            w = np.full(threads, -1)
            part = key[lo:lo + threads]
            w[:len(part)] = part
            w = w.reshape(n_warps, 32)
            hist = np.stack([(w == b).sum(1) for b in range(nb)])
            in_warp = ((w[:, :, None] == w[:, None, :]) & lower).sum(2)
            offset = running[:, None] + np.cumsum(hist, 1) - hist
            for wi, li in zip(*np.nonzero(w >= 0)):
                b = w[wi, li]
                slot = offset[b, wi] + in_warp[wi, li]
                if slot < cap:
                    out[row, b, slot] = words[row, lo + wi * 32 + li]
            running += hist.sum(1)
        counts[row] = running
    overflow = np.maximum(counts - cap, 0).sum(-1).astype(np.int32)
    return out, counts, overflow


@pytest.mark.parametrize("lanes", [10, 300, 1000, 1024, 2048, 2500])
@pytest.mark.parametrize("nb", [7, 46])
def test_bucket_pack_block_arithmetic_equals_plain(nb, lanes):
    """The kernel's per-warp ranks, scanned over the warps, plus the
    earlier tiles' per-bucket totals give the plain version's slab, counts
    and overflow: rows shorter than a warp's multiple (10, 300, 1000), one
    whole tile (1024), two (2048, the wafer's rows) and a ragged last tile
    (2500); out-of-range and negative ids, an all-invalid row and buckets
    over capacity."""
    cap = 12
    bid, addr, dead, valid = _pack_lanes(nb * lanes, (3, lanes), -2, nb + 2)
    valid[0] = False
    words = np.asarray(jev.encode_word(addr, dead, valid))
    threads = bp.launch_plan(lanes, nb, cap)[0]
    got = _block_pack_np(bid, words, nb, cap, threads)
    want = bp.bucket_pack(*map(T, (bid, addr, dead, valid)), n_buckets=nb,
                          capacity=cap)
    for g, w, name in zip(got, want, ("words", "counts", "overflow")):
        same(g, w, name)
    assert not got[1][0].any()
    assert (got[2][1:] > 0).any() == (lanes > nb * cap)


def test_bucket_pack_launch_plan():
    """One lane per thread up to 1024 threads (longer rows loop over
    tiles); shared memory holds the cells, the per-warp bucket histogram
    and the running counts, and a plan past a Hopper block's is refused."""
    assert bp.launch_plan(2048, 46, 32) == (1024, 4 * 46 * (32 + 32 + 1))
    assert bp.launch_plan(1000, 46, 32)[0] == 1024
    assert bp.launch_plan(300, 7, 12) == (320, 4 * 7 * (12 + 10 + 1))
    assert bp.launch_plan(1, 7, 12)[0] == 32
    with pytest.raises(ValueError, match="shared memory"):
        bp.launch_plan(1 << 16, 2000, 32)


# ---------------------------------------------------------------------------
# fused_drain
# ---------------------------------------------------------------------------

GATES = {"none": None, "on": [True] * N_CHIPS, "off": [False] * N_CHIPS,
         "mixed": [True, False, True]}


def _drain_case(b, mode, seed=0):
    rng = np.random.default_rng(seed + b + len(mode))
    d, n_in, depth, lanes = 12, 40, 16, 30
    t0 = np.array([0, 250, 254], np.int32)

    def words(shape, now, spread, p):
        addr = rng.integers(0, 64, shape)      # past n_in: clipped
        dead = now + rng.integers(-6, spread, shape)
        return np.asarray(jev.encode_word(addr, dead, rng.random(shape) < p))

    delivered = words((N_CHIPS, b, lanes), t0[:, None, None], 40, 0.7)
    queue = (words((N_CHIPS, depth), t0[:, None], 10, 0.9)
             if mode == "rate" else None)
    ring = rng.integers(0, 3, (N_CHIPS, d, n_in)).astype(np.int32)
    return ring, delivered, queue, t0


def _jax_drain(fn, case, gate, kw):
    ring, delivered, queue, t0 = case
    jring = jdl.DelayRing(ring=jnp.asarray(ring), now=jnp.asarray(t0))
    q = None if queue is None else jnp.asarray(queue)
    g = None if gate is None else jnp.asarray(gate)
    return jax.vmap(lambda r, dv, qq, t, gg: fn(r, dv, qq, t, gate=gg, **kw))(
        jring, jnp.asarray(delivered), q, jnp.asarray(t0), g)


def _port_drain(case, gate, kw):
    ring, delivered, queue, t0 = case
    return fd.fused_drain(
        dl.DelayRing(T(ring), T(t0)), T(delivered),
        None if queue is None else T(queue), T(t0),
        gate=None if gate is None else T(gate), **kw)


def _check_drain(want, got, mode):
    same(want.ring.ring, got.ring.ring, "ring")
    for f in ("words", "dep_expired", "dropped"):
        same(np.swapaxes(np.asarray(getattr(want, f)), 0, 1),
             getattr(got, f), f)
    if mode == "rate":
        same(want.queue, got.queue, "queue")


@pytest.mark.parametrize("gate", list(GATES))
@pytest.mark.parametrize("mode", ["passthrough", "sort", "rate"])
@pytest.mark.parametrize("b", [1, 4])
def test_fused_drain_plain_matches_reference(b, mode, gate):
    case = _drain_case(b, mode)
    for extra_ahead in (0, b):
        kw = dict(mode=mode, rate=3, extra_ahead=extra_ahead)
        want = _jax_drain(jfd_ref, case, GATES[gate], kw)
        got = _port_drain(case, GATES[gate], kw)
        _check_drain(want, got, mode)
        if gate == "off":
            assert not bool(ev.word_valid(got.words).any())


@pytest.mark.parametrize("mode", ["passthrough", "sort", "rate"])
def test_fused_drain_plain_matches_pallas_interpret(mode):
    case = _drain_case(4, mode, seed=5)
    kw = dict(mode=mode, rate=3, extra_ahead=0)
    want = _jax_drain(
        lambda *a, **k: jfd.fused_drain(*a, interpret=True, **k), case,
        GATES["mixed"], kw)
    _check_drain(want, _port_drain(case, GATES["mixed"], kw), mode)


def test_fused_drain_rate_mode_needs_a_queue():
    ring, delivered, _, t0 = _drain_case(1, "sort")
    with pytest.raises(ValueError, match="queue"):
        fd.fused_drain(dl.DelayRing(T(ring), T(t0)), T(delivered), None,
                       T(t0), mode="rate", rate=3)


def test_sort_length_covers_queue_lanes_and_rate():
    """The counting merge sorts the queue and the lanes unpadded; the
    rate window past them is filled with sentinels, not sorted."""
    assert fd.sort_length("passthrough", 1472, 0) == 0
    assert fd.sort_length("sort", 30, 0) == 30
    assert fd.sort_length("sort", 2944, 0) == 2944
    assert fd.sort_length("rate", 2944, 64) == 3008
    assert fd.sort_length("rate", 3968, 64) == 4032


def _ff_drain_case(b, fill, seed=0):
    """A block at the feedforward path's drain widths (2944 lanes, queue
    depth 64, ring [32, 256]) on 3 chips with clocks across the 255 -> 0
    wrap: rows of no valid word, a light load (the queue fills and some
    substeps drop), a congested one and all words valid."""
    p = {"empty": 0.0, "light": 0.06, "congested": 0.7, "full": 1.0}[fill]
    rng = np.random.default_rng(seed + b + len(fill))
    d, n_in, depth, lanes = 32, 256, 64, 2944
    t0 = np.array([0, 250, 254], np.int32)

    def words(shape, now):
        addr = rng.integers(0, n_in + 40, shape)
        dead = now + rng.integers(-6, 40, shape)
        return np.asarray(jev.encode_word(addr, dead, rng.random(shape) < p))

    delivered = words((N_CHIPS, b, lanes), t0[:, None, None])
    queue = words((N_CHIPS, depth), t0[:, None])
    ring = rng.integers(0, 3, (N_CHIPS, d, n_in)).astype(np.int32)
    return ring, delivered, queue, t0


@pytest.mark.parametrize("mode,fill,gate", [
    ("rate", "light", "none"), ("rate", "congested", "none"),
    ("rate", "congested", "mixed"), ("rate", "empty", "none"),
    ("rate", "full", "mixed"), ("sort", "congested", "mixed"),
    ("sort", "full", "none")])
def test_fused_drain_plain_matches_reference_at_feedforward_widths(
        mode, fill, gate):
    """B 8 at the path's widths, rate 128: the merge queue congests and
    drops (rate small against the lanes)."""
    ring, delivered, queue, t0 = _ff_drain_case(8, fill)
    case = (ring, delivered, queue if mode == "rate" else None, t0)
    kw = dict(mode=mode, rate=128 if mode == "rate" else 0, extra_ahead=1)
    want = _jax_drain(jfd_ref, case, GATES[gate], kw)
    got = _port_drain(case, GATES[gate], kw)
    _check_drain(want, got, mode)
    if mode == "rate" and fill != "empty":
        assert int(got.dropped.max()) > 0
    if fill == "empty":
        assert not bool(ev.word_valid(got.words).any())


def test_fused_drain_launch_plan_at_the_feedforward_path():
    """8 warp groups of 4 warps sort the block's 8 rows at once; B 1 takes
    one group of 32 warps."""
    ring = 32 * 256
    rate_ints = 8 * (257 + 192) + 3 * 64    # heads, ends, queues, keys
    assert fd.launch_plan("passthrough", 2944, 0, 0, 8, 32, 256) == (
        1024, 1, 4 * (ring + 16))
    assert fd.launch_plan("rate", 2944, 64, 128, 8, 32, 256) == (
        1024, 8, 4 * (ring + 16 + rate_ints + 8 * (2944 + 257 * 5 + 32)))
    assert fd.launch_plan("sort", 2944, 0, 0, 8, 32, 256) == (
        1024, 8, 4 * (ring + 16 + 8 * (2944 + 257 * 5 + 32)))
    assert fd.launch_plan("rate", 2944, 64, 128, 1, 32, 256)[:2] == (1024, 1)
    assert fd.launch_plan("sort", 300, 0, 0, 4, 12, 40) == (
        1024, 4, 4 * (12 * 40 + 8 + 4 * (300 + 257 * 9 + 32)))


@pytest.mark.parametrize("mode,depth,rate,largest", [("rate", 64, 128, 37607),
                                                     ("sort", 0, 0, 41391)])
def test_fused_drain_launch_plan_refuses_one_lane_past_its_limit(
        mode, depth, rate, largest):
    """Past 8 groups' rows the plan takes fewer groups; one group's staged
    row, 33 histogram columns and the rate mode's heads beside the ring
    [32, 256] fill a Hopper block's 232,448 B at ``largest`` lanes (B 8)."""
    assert fd.launch_plan(mode, largest, depth, rate, 8, 32, 256)[1:] == (
        1, kc.MAX_SMEM)
    with pytest.raises(ValueError, match="shared memory"):
        fd.launch_plan(mode, largest + 1, depth, rate, 8, 32, 256)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_cpu_tensors_run_the_plain_versions_without_launching():
    kc.reset_launches()
    events, table, t0, cap = _inject_case(1, "random")
    fi.fused_inject(ev.EventBuffer(*map(T, events)),
                    rt.RoutingTable(*map(T, table)), T(t0),
                    n_chips=N_CHIPS, buckets_per_chip=1, capacity=cap)
    bp.bucket_pack(*map(T, _pack_lanes(0, (10,), 0, 3)), n_buckets=3,
                   capacity=2)
    _port_drain(_drain_case(1, "sort"), None, dict(mode="sort"))
    assert kc.launches == {name: 0 for name in kc.KERNELS}
    with pytest.raises(ValueError, match="CUDA"):
        kc.check(torch.zeros(3, dtype=torch.int32), "x", torch.int32, (3,))

