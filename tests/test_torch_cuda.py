"""The port's CUDA kernels against their plain PyTorch versions on the
card (the SNN kernels bitwise, flash attention and the SSM scan within a
stated tolerance), the feedforward demo and a reduced LM serve on the
card against the CPU.

These tests need an NVIDIA GPU and skip without one (a CUDA kernel has no
CPU mode).  They import no JAX, so they run on a machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import delays as dl
from repro_torch.core import events as ev
from repro_torch.core import routing as rt
from repro_torch.kernels import common as kc
from repro_torch.kernels.bucket_pack import ops as bp
from repro_torch.kernels.bucket_pack.ref import bucket_pack_ref
from repro_torch.kernels.fused_drain import ops as fd
from repro_torch.kernels.fused_drain.ref import fused_drain_ref
from repro_torch.kernels.fused_inject import ops as fi
from repro_torch.kernels.fused_inject.ref import (fused_inject_ref,
                                                 fused_lif_inject_ref)
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.lif_step import ops as lif
from repro_torch.kernels.lif_step.ref import lif_step_ref
from repro_torch.kernels.merge_sort import ops as ms
from repro_torch.kernels.merge_sort.ref import merge_sort_ref, merge_sort_words_ref
from repro_torch.kernels.ssm_scan import ops as scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.core import merge as mg
from repro_torch.snn import neuron as nr

N_CHIPS = 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(x, device):
    return torch.as_tensor(np.array(x), device=device)


def _equal(got, want):
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["simplified", "full"])
@pytest.mark.parametrize("b", [1, 8])
def test_fused_inject_kernel_matches_plain(cuda, b, mode):
    rng = np.random.default_rng(b)
    n, e = 40, 70
    t0 = _on(np.array([0, 100, 250, 254, 7], np.int32), cuda)
    events = ev.EventBuffer(
        _on(rng.integers(-3, n + 3, (b, N_CHIPS, e)).astype(np.int32), cuda),
        (t0[None, :, None]
         + _on(rng.integers(0, b + 1, (b, N_CHIPS, e)), cuda)).int(),
        _on(rng.random((b, N_CHIPS, e)) < 0.7, cuda))
    table = rt.RoutingTable(
        _on(rng.integers(-2, N_CHIPS, (N_CHIPS, n, 1)).astype(np.int32),
            cuda),
        _on(rng.integers(0, n, (N_CHIPS, n, 1)).astype(np.int32), cuda),
        _on(rng.choice([0, 3, 9, 12, 130], (N_CHIPS, n, 1)).astype(np.int32),
            cuda),
        _on(rng.random((N_CHIPS, n, 1)) < 0.9, cuda))
    kw = dict(n_chips=N_CHIPS, buckets_per_chip=2, capacity=3, mode=mode,
              time_window=4)
    before = kc.launches["fused_inject"]
    got = fi.fused_inject(events, table, t0, **kw)
    assert kc.launches["fused_inject"] == before + 1
    _equal(got, fused_inject_ref(events, table, t0, **kw))


def _inject_block(rng, b, e, kind, device, n=40):
    """An event block and a table: ``in_range`` destinations, ``negative``
    ones down to -2, or ``minus_one`` on every entry (every admitted
    lane's bucket wraps and lanes collide on cells); row (0, 0) all
    invalid, and chip 1's in-range entries all to chip 1 (its buckets
    overflow)."""
    t0 = np.array([0, 100, 250, 254, 7], np.int32)
    addr = rng.integers(-3, n + 3, (b, N_CHIPS, e)).astype(np.int32)
    time = (t0[None, :, None] + rng.integers(0, b + 1, (b, N_CHIPS, e))
            ).astype(np.int32)
    valid = rng.random((b, N_CHIPS, e)) < 0.7
    valid[0, 0] = False
    dest = rng.integers({"in_range": 0, "negative": -2}.get(kind, -1),
                        N_CHIPS if kind != "minus_one" else 0,
                        (N_CHIPS, n, 1)).astype(np.int32)
    dest[1] = np.where(dest[1] < 0, dest[1], 1)
    events = ev.EventBuffer(_on(addr, device), _on(time, device),
                            _on(valid, device))
    table = rt.RoutingTable(
        _on(dest, device),
        _on(rng.integers(0, n, (N_CHIPS, n, 1)).astype(np.int32), device),
        _on(rng.choice([0, 3, 9, 12, 130], (N_CHIPS, n, 1)).astype(np.int32),
            device),
        _on(rng.random((N_CHIPS, n, 1)) < 0.9, device))
    return events, table, _on(t0, device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["simplified", "full"])
@pytest.mark.parametrize("kind,lanes,cap", [
    ("in_range", 512, 32), ("in_range", 70, 3), ("negative", 1500, 8),
    ("minus_one", 512, 32)])
def test_fused_inject_edge_rows_match_plain(cuda, kind, lanes, cap, mode):
    """Bitwise against the plain version, B 8: in-range tables (words
    stored straight into the slab; the sentinel by 16-byte stores at C 32,
    by words at C 3), rows of 1500 lanes (three tiles of 512, the cells
    resolved in shared memory), a table of dest_chip -1 throughout (the
    block vote finds wrapping lanes), an all-invalid row and buckets over
    capacity; one launch of the one kernel per call."""
    events, table, t0 = _inject_block(np.random.default_rng(lanes + cap), 8,
                                      lanes, kind, cuda)
    kw = dict(n_chips=N_CHIPS, buckets_per_chip=2, capacity=cap, mode=mode,
              time_window=4)
    run = lambda: fi.fused_inject(events, table, t0, **kw)
    before = kc.launches["fused_inject"]
    run()
    assert kc.launches["fused_inject"] == before + 1
    got, names = kc.card_kernels(run)
    assert len(names) == 1 and "fused_inject_kernel" in names[0], names
    want = fused_inject_ref(events, table, t0, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want.sent[0, 0]) == 0
    if kind != "minus_one":
        assert int(want.overflow.sum()) > 0


def _reach(device):
    """Unreachable pairs: chip 1 reaches only itself, chips 0 and 3 do not
    reach chip 2."""
    reach = np.ones((N_CHIPS, N_CHIPS), bool)
    reach[1] = False
    reach[1, 1] = True
    reach[[0, 3], 2] = False
    return _on(reach, device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["simplified", "full"])
@pytest.mark.parametrize("kind,lanes", [("in_range", 512), ("negative", 1500),
                                        ("in_range", 70)])
def test_fused_inject_with_reach_matches_plain(cuda, kind, lanes, mode):
    """The reach cull, B 8, bitwise against the plain version (``lost``
    included): one tile (the row loaded after the lanes, under its own
    barrier), three tiles of 512, and a short row; one launch of the one
    kernel per call."""
    events, table, t0 = _inject_block(np.random.default_rng(lanes + 1), 8,
                                      lanes, kind, cuda)
    kw = dict(reach=_reach(cuda), n_chips=N_CHIPS, buckets_per_chip=2,
              capacity=8, mode=mode, time_window=4)
    run = lambda: fi.fused_inject(events, table, t0, **kw)
    before = kc.launches["fused_inject"]
    run()
    assert kc.launches["fused_inject"] == before + 1
    got, names = kc.card_kernels(run)
    assert len(names) == 1 and "fused_inject_kernel" in names[0], names
    want = fused_inject_ref(events, table, t0, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # Chip 1's in-range entries all go to chip 1 itself, which it
    # reaches; chips 0 and 3 lose their words for chip 2.
    assert int(want.lost[:, [0, 3]].sum()) > 0
    assert int(want.lost[:, 1].sum()) == 0
    free = fi.fused_inject(events, table, t0, **dict(kw, reach=None))
    assert int(free.lost.sum()) == 0
    assert torch.equal(free.sent, want.sent)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 700])
def test_fused_lif_inject_with_reach_matches_plain(cuda, n):
    """``fused_lif_inject`` with a reach row (one tile and two), B 8,
    bitwise, ``lost`` included."""
    rng = np.random.default_rng(n)
    v, refrac, _, *params = _lif_args(rng, (N_CHIPS, n), cuda)
    currents = _on(rng.normal(0.5, 0.8, (8, N_CHIPS, n)).astype(np.float32),
                   cuda)
    table = rt.RoutingTable(
        _on(rng.integers(-1, N_CHIPS, (N_CHIPS, n, 1)).astype(np.int32),
            cuda),
        _on(rng.integers(0, n, (N_CHIPS, n, 1)).astype(np.int32), cuda),
        _on(rng.integers(8, 20, (N_CHIPS, n, 1)).astype(np.int32), cuda),
        _on(rng.random((N_CHIPS, n, 1)) < 0.9, cuda))
    t0 = _on(np.array([0, 100, 250, 254, 7], np.int32), cuda)
    kw = dict(reach=_reach(cuda), event_capacity=200, n_chips=N_CHIPS,
              buckets_per_chip=2, capacity=16, mode="full", time_window=4)
    lifp = nr.LIFParams(*params)
    before = kc.launches["fused_lif_inject"]
    got = fi.fused_lif_inject(v, refrac, currents, lifp, table, t0, **kw)
    assert kc.launches["fused_lif_inject"] == before + 1
    want = fused_lif_inject_ref(v, refrac, currents, lifp, table, t0, **kw)
    for name in ("v", "refrac", "spikes", "voltage"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for g, w in zip(got.inject, want.inject):
        assert torch.equal(g, w)
    assert int(want.inject.lost.sum()) > 0


@pytest.mark.cuda
def test_degraded_routed_network_on_the_card_matches_the_cpu(cuda):
    """A network on a degraded torus (a dead chip, a cut link) with the
    fused inject and its reach row: spikes, ring and every integer stat
    on the card equal the CPU's."""
    from repro_torch.core import topology as tpo
    from repro_torch.core import pulse_comm as pc
    from repro_torch.snn import network as net

    comm = pc.PulseCommConfig(n_chips=8, neurons_per_chip=64,
                              n_inputs_per_chip=64, event_capacity=64,
                              bucket_capacity=8, buckets_per_chip=2,
                              mode="full", merge_rate=8, ring_depth=20,
                              superstep=4)
    cfg = net.NetworkConfig(comm=comm, topology=tpo.torus2d(
        2, 4, link_latency=1), healthy=(0, 1, 2, 3, 4, 6, 7),
        dead_links=((1, 2),))
    gen = torch.Generator().manual_seed(0)
    table = rt.random_table(gen, 64, 8, min_delay=6, max_delay=12)
    params = net.init_params(gen, cfg, table=table, device="cpu")
    params = params._replace(crossbar=params.crossbar._replace(
        w=torch.round(params.crossbar.w * 64) / 64))
    ext = (torch.rand((16, 8, 64), generator=gen) < 0.1).float() * 2
    out = {}
    for dev in ("cpu", cuda):
        p = type(params)(*(_tree_to(x, dev) for x in params))
        final, rec = net.run(cfg, p, net.init_state(cfg, p, device=dev),
                             ext.to(dev), device=dev)
        out[str(dev)] = (final, rec)
    (cf, cr), (gf, gr) = out["cpu"], out[str(cuda)]
    assert torch.equal(gr.spikes.cpu(), cr.spikes)
    assert torch.equal(gf.ring.ring.cpu(), cf.ring.ring)
    for f in cr.stats._fields:
        if f != "utilization":
            assert torch.equal(getattr(gr.stats, f).cpu(),
                               getattr(cr.stats, f)), f
    assert int(cr.stats.lost_to_failure.sum()) > 0


def _tree_to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return type(x)(*(_tree_to(v, device) for v in x))


@pytest.mark.cuda
def test_bucket_pack_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    shape = (3, N_CHIPS, 1500)     # more lanes than threads: several tiles
    bid, addr, dead = (_on(rng.integers(lo, hi, shape).astype(np.int32), cuda)
                       for lo, hi in ((-2, 9), (0, 1 << 14), (0, 256)))
    valid = _on(rng.random(shape) < 0.8, cuda)
    slab, counts, overflow = bp.flush_pack(bid, addr, dead, valid,
                                           n_buckets=7, capacity=32)
    rows, want_counts, want_overflow = bucket_pack_ref(
        bid, ev.encode_word(addr, dead, valid), n_buckets=7, capacity=32)
    assert torch.equal(slab, rows.permute(1, 2, 0, 3))
    assert torch.equal(counts, want_counts)
    assert torch.equal(overflow, want_overflow)


def _edge_lanes(rng, shape, nb, cap):
    """Lanes with out-of-range and negative bucket ids, masked-off addr and
    deadline bits, an all-invalid first row, word 0 (addr 0 or 2^14,
    deadline 0 or 256) and one bucket over capacity in the last row."""
    bid = rng.integers(-3, nb + 3, shape).astype(np.int32)
    addr = rng.integers(-5, 1 << 15, shape).astype(np.int32)
    dead = rng.integers(-300, 600, shape).astype(np.int32)
    valid = rng.random(shape) < 0.8
    flat = [x.reshape(-1, shape[-1]) for x in (bid, addr, dead, valid)]
    flat[3][0] = False
    zero = rng.random(shape[-1]) < 0.05
    for row in range(1, flat[0].shape[0]):
        flat[1][row, zero] = rng.choice([0, 1 << 14], int(zero.sum()))
        flat[2][row, zero] = rng.choice([0, 256], int(zero.sum()))
    flat[0][-1, : 3 * cap] = 1
    flat[3][-1, : 3 * cap] = True
    return bid, addr, dead, valid


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["bucket_pack", "flush_pack"])
@pytest.mark.parametrize("shape", ["ragged", "long", "many_rows", "wafer"])
def test_bucket_pack_lanes_match_plain(cuda, shape, layout):
    """Bitwise against the plain version: lanes not a multiple of 32
    (1000), rows longer than 1024 lanes (the tile loop), more rows than the
    card has SMs, and the wafer's 46 rows of 2048; one launch of the one
    kernel per call and no other CUDA work."""
    nb, cap = 40, 16
    lanes = {"ragged": 1000, "long": 2 * 1024 + 777, "many_rows": 300,
             "wafer": 2048}[shape]
    lead = {"ragged": (1, 3), "long": (2, 2), "many_rows": (2, 100),
            "wafer": (1, 46)}[shape]
    rng = np.random.default_rng(len(shape))
    bid, addr, dead, valid = (_on(x, cuda) for x in _edge_lanes(
        rng, lead + (lanes,), nb, cap))
    fn = bp.bucket_pack if layout == "bucket_pack" else bp.flush_pack
    run = lambda: fn(bid, addr, dead, valid, n_buckets=nb, capacity=cap)
    before = kc.launches["bucket_pack"]
    run()
    assert kc.launches["bucket_pack"] == before + 1
    got, names = kc.card_kernels(run)
    assert len(names) == 1 and "bucket_pack_kernel" in names[0], names
    rows, counts, overflow = bucket_pack_ref(
        bid, ev.encode_word(addr, dead, valid), n_buckets=nb, capacity=cap)
    if layout == "flush_pack":
        rows = rows.permute(1, 2, 0, 3)
    got_rows = got[0] if layout == "flush_pack" else got.words
    assert torch.equal(got_rows, rows)
    assert torch.equal(got[1] if layout == "flush_pack" else got.counts,
                       counts)
    assert torch.equal(got[2] if layout == "flush_pack" else got.overflow,
                       overflow)
    assert int(overflow.reshape(-1)[-1]) > 0 and int(counts[0, 0].sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["passthrough", "sort", "rate"])
def test_fused_drain_kernel_matches_plain(cuda, mode):
    rng = np.random.default_rng(len(mode))
    b, d, n_in, depth, lanes = 4, 12, 40, 16, 300
    t0 = _on(np.array([0, 250, 254, 3, 128], np.int32), cuda)

    def words(shape, spread, p):
        now = t0.cpu().numpy().reshape((-1,) + (1,) * (len(shape) - 1))
        addr = rng.integers(0, 64, shape)
        dead = now + rng.integers(-6, spread, shape)
        valid = rng.random(shape) < p
        w = ((addr & 0x3FFF) << 8) | (dead & 0xFF)
        return _on(np.where(valid, w, -1).astype(np.int32), cuda)

    delivered = words((N_CHIPS, b, lanes), 40, 0.7)
    queue = words((N_CHIPS, depth), 10, 0.9) if mode == "rate" else None
    ring = dl.DelayRing(
        _on(rng.integers(0, 3, (N_CHIPS, d, n_in)).astype(np.int32), cuda),
        t0)
    for gate in (None, _on([True, False, True, True, False], cuda)):
        kw = dict(mode=mode, rate=3, extra_ahead=1, gate=gate)
        got = fd.fused_drain(ring, delivered, queue, t0, **kw)
        want = fused_drain_ref(ring, delivered, queue, t0, **kw)
        assert torch.equal(got.ring.ring, want.ring.ring)
        _equal(got[1:], want[1:])


def _drain_block(rng, n, b, lanes, depth, t0, p=0.7, spread=(-6, 40),
                 n_in=256):
    """Delivered rows [n, b, lanes] and a queue [n, depth] of wire words
    (valid with probability p, deadlines now + spread, addresses up to
    past n_in so some are clipped), on the host."""
    def words(shape, now):
        addr = rng.integers(0, n_in + 40, shape)
        dead = now + rng.integers(*spread, shape)
        w = (addr << 8) | (dead & 0xFF)
        return np.where(rng.random(shape) < p, w, -1).astype(np.int32)

    return (words((n, b, lanes), t0[:, None, None]),
            words((n, depth), t0[:, None]))


def _check_drain_case(ring, delivered, queue, t0, **kw):
    """The kernel against its plain version, bitwise, on every output;
    returns the kernel's."""
    before = kc.launches["fused_drain"]
    got = fd.fused_drain(ring, delivered, queue, t0, **kw)
    assert kc.launches["fused_drain"] == before + 1
    want = fused_drain_ref(ring, delivered, queue, t0, **kw)
    assert torch.equal(got.ring.ring, want.ring.ring)
    for f in ("words", "dep_expired", "dropped"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if kw.get("mode") == "rate":
        assert torch.equal(got.queue, want.queue)
    return got


def _largest_drain_lanes(mode, depth, rate, b, d, n_in):
    lo, hi = 1, 1 << 17
    while lo < hi:
        mid = (lo + hi + 1) // 2
        try:
            fd.launch_plan(mode, mid, depth, rate, b, d, n_in)
            lo = mid
        except ValueError:
            hi = mid - 1
    return lo


# The feedforward path's drain: 46 chips, 2944 lanes, queue depth 64, rate
# 128, B 8, ring [32, 256].
_PATH = dict(n=46, b=8, lanes=2944, depth=64, rate=128, d=32, n_in=256)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "path", "congested", "no_valid", "all_valid", "wrap", "word0",
    "queue_row_ties", "mixed_gate", "sort_ragged", "rounds", "largest_rate",
    "largest_sort"])
def test_fused_drain_counting_merge_matches_plain(cuda, case):
    """The counting merge bitwise against the plain drain at the path's
    widths, and on the inputs that pin its hazards."""
    rng = np.random.default_rng(sum(map(ord, case)))
    c = dict(_PATH)
    mode, gate, p, spread, extra = "rate", None, 0.7, (-6, 40), 0
    if case == "path":
        p = 0.06            # the queue fills and some substeps drop
    elif case == "no_valid":
        p = 0.0
    elif case == "all_valid":
        p = 1.0
    elif case == "wrap":
        spread = (-130, 130)  # keys over the whole window, both sides
    elif case == "word0":
        p = 0.02
    elif case == "queue_row_ties":
        spread = (6, 40)    # every other word after the tied deadline
    elif case == "mixed_gate":
        gate = torch.arange(c["n"], device=cuda) % 3 != 1
        extra = 2
    elif case == "sort_ragged":
        mode, c["lanes"], gate = "sort", 2941, torch.arange(
            c["n"], device=cuda) % 2 == 0
    elif case == "rounds":
        c.update(b=12, lanes=700)   # 8 groups: four of them sort two rows
    elif case.startswith("largest"):
        # one group of 32 warps sorting both rows in turn
        mode = case.split("_")[1]
        depth = c["depth"] if mode == "rate" else 0
        c.update(n=5, b=2, lanes=_largest_drain_lanes(
            mode, depth, c["rate"], 2, c["d"], c["n_in"]))
    t0_np = ((np.arange(c["n"]) * 37 + 240) % 256).astype(np.int32)
    delivered, queue = _drain_block(rng, c["n"], c["b"], c["lanes"],
                                    c["depth"], t0_np, p, spread,
                                    c["n_in"])
    if case == "word0":
        # word 0: address 0, deadline 0 mod 256, valid, on every row
        t0_np[:] = 240
        delivered[:, :, ::97] = 0
    if case == "queue_row_ties":
        # one deadline for the whole queue and the first 100 row lanes:
        # equal keys across the boundary keep the queue lanes first
        dead = (t0_np[:, None] + 5) & 0xFF
        queue = ((np.arange(c["depth"])[None, :] << 8) | dead).astype(
            np.int32)
        delivered[:, 0, :100] = (((np.arange(100) + 100)[None, :] << 8)
                                 | dead).astype(np.int32)
    t0 = _on(t0_np, cuda)
    ring = dl.DelayRing(
        _on(rng.integers(0, 3, (c["n"], c["d"], c["n_in"])).astype(np.int32),
            cuda), t0)
    got = _check_drain_case(
        ring, _on(delivered, cuda), _on(queue, cuda) if mode == "rate"
        else None, t0, mode=mode, rate=c["rate"] if mode == "rate" else 0,
        extra_ahead=extra, gate=gate)
    if case in ("congested", "all_valid", "largest_rate"):
        assert int(got.dropped.min()) > 0
        assert bool((got.queue >= 0).all())
    if case == "path":
        assert int(got.dropped.max()) > 0
    if case == "no_valid":
        assert not bool((got.words >= 0).any())
        assert int(got.dropped.max()) == 0
    if case == "word0":
        assert bool((got.words == 0).any())
    if case == "queue_row_ties":
        assert torch.equal(got.words[0, :, :c["depth"]], _on(queue, cuda))
        assert torch.equal(got.words[0, :, c["depth"]:],
                           _on(delivered[:, 0, :c["rate"] - c["depth"]],
                               cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rate", "sort"])
def test_fused_drain_refuses_one_lane_past_its_plan(cuda, mode):
    depth = 64 if mode == "rate" else 0
    lanes = _largest_drain_lanes(mode, depth, 128, 1, 32, 256) + 1
    t0 = _on(np.zeros(2, np.int32), cuda)
    ring = dl.DelayRing(torch.zeros((2, 32, 256), dtype=torch.int32,
                                    device=cuda), t0)
    delivered = torch.full((2, 1, lanes), -1, dtype=torch.int32, device=cuda)
    queue = (torch.full((2, depth), -1, dtype=torch.int32, device=cuda)
             if mode == "rate" else None)
    with pytest.raises(ValueError, match="shared memory"):
        fd.fused_drain(ring, delivered, queue, t0, mode=mode,
                       rate=128 if mode == "rate" else 0)


def _lif_args(rng, shape, device):
    f32 = lambda lo, hi: _on(rng.uniform(lo, hi, shape).astype(np.float32),
                             device)
    i32 = lambda lo, hi: _on(rng.integers(lo, hi, shape).astype(np.int32),
                             device)
    return (f32(-0.5, 1.5), i32(-1, 3), f32(-0.5, 1.5), f32(1.5, 30.0),
            f32(0.5, 1.2), f32(-0.2, 0.0), f32(-0.1, 0.1), i32(1, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["rate", "sort", "passthrough"])
@pytest.mark.parametrize("gate", ["open", "closed"])
def test_fused_drain_pipelined_gates_match_plain(cuda, mode, gate):
    """The pipelined schedule's drains at the path's widths: a steady
    stage (``extra_ahead`` B, gate all true; deposits within 2B - 1 of
    the clock expire) and the prologue (gate all false: sentinel words,
    the queue kept, no deposit and no expiry)."""
    rng = np.random.default_rng(len(mode) + len(gate))
    c = dict(_PATH)
    t0_np = ((np.arange(c["n"]) * 37 + 240) % 256).astype(np.int32)
    delivered, queue = _drain_block(rng, c["n"], c["b"], c["lanes"],
                                    c["depth"], t0_np, 0.06, (-6, 40),
                                    c["n_in"])
    t0 = _on(t0_np, cuda)
    ring = dl.DelayRing(
        _on(rng.integers(0, 3, (c["n"], c["d"], c["n_in"])).astype(np.int32),
            cuda), t0)
    rate = mode == "rate"
    got = _check_drain_case(
        ring, _on(delivered, cuda), _on(queue, cuda) if rate else None, t0,
        mode=mode, rate=c["rate"] if rate else 0, extra_ahead=c["b"],
        gate=torch.full((c["n"],), gate == "open", device=cuda))
    if gate == "closed":
        assert torch.equal(got.ring.ring, ring.ring)
        assert not bool((got.words >= 0).any())
        assert int(got.dep_expired.abs().sum()) == 0
        if rate:
            assert torch.equal(got.queue, _on(queue, cuda))
    else:
        assert int(got.dep_expired.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [100, 2560])
def test_bucket_pack_column_matches_plain(cuda, lanes):
    """One substep packed into column k of an existing slab in place, as
    the credit-gated inject does: the column equals the plain version's,
    every other column keeps its words, one launch."""
    rng = np.random.default_rng(lanes)
    n, nb, b, cap = N_CHIPS, 2 * N_CHIPS, 3, 16
    bid, addr, dead, valid = (_on(x, cuda) for x in _edge_lanes(
        rng, (n, lanes), nb, cap))
    slab0 = _on(rng.integers(-1, 1 << 22, (n, nb, b, cap)).astype(np.int32),
                cuda)
    for k in range(b):
        slab = slab0.clone()
        before = kc.launches["bucket_pack"]
        counts, overflow = bp.flush_pack_column(
            bid, addr, dead, valid, slab=slab, substep=k, capacity=cap)
        assert kc.launches["bucket_pack"] == before + 1
        want = slab0.cpu().clone()
        want_counts, want_overflow = bp.flush_pack_column(
            bid.cpu(), addr.cpu(), dead.cpu(), valid.cpu(), slab=want,
            substep=k, capacity=cap)
        assert torch.equal(slab.cpu(), want)
        assert torch.equal(counts.cpu(), want_counts)
        assert torch.equal(overflow.cpu(), want_overflow)
        others = [j for j in range(b) if j != k]
        assert torch.equal(slab[:, :, others], slab0[:, :, others])


@pytest.mark.cuda
def test_pipelined_flow_network_on_the_card_matches_the_cpu(cuda):
    """A small network on the pipelined schedule under credits with a
    send queue, fan-out 2, B 2: spikes, every integer stat, the ring, the
    credits and the queue equal the same run on the CPU (voltages within
    1e-5: ``expf`` against ``exp``)."""
    from repro_torch.core import fabric as fb
    from repro_torch.core import pulse_comm as pc
    from repro_torch.snn import network as net
    from repro_torch.snn import synapse as sy

    comm = pc.PulseCommConfig(n_chips=4, neurons_per_chip=64,
                              n_inputs_per_chip=64, event_capacity=64,
                              fanout=2, bucket_capacity=8,
                              buckets_per_chip=2, ring_depth=24,
                              mode="full", merge_rate=8, merge_depth=16,
                              superstep=2)
    cfg = net.NetworkConfig(comm=comm, pipeline=True,
                            flow=fb.FlowControlConfig(
                                capacity=3, drain_rate=2,
                                retransmit_depth=32))
    gen = torch.Generator().manual_seed(0)
    table = rt.random_table(gen, 64, 4, fanout=2, min_delay=6, max_delay=20)
    params = net.init_params(gen, cfg, table=table, device="cpu")
    params = params._replace(crossbar=sy.Crossbar(
        w=torch.round(params.crossbar.w * 64) / 64))
    ext = torch.as_tensor((np.random.default_rng(0).random((32, 4, 64))
                           < 0.1).astype(np.float32))
    out = []
    for device in (cuda, torch.device("cpu")):
        p = type(params)(*(type(x)(*(t.to(device) for t in x))
                           for x in params))
        kc.reset_launches()
        final, rec = net.run(cfg, p, net.init_state(cfg, p, device=device),
                             ext.to(device), device=device)
        out.append((final, rec, dict(kc.launches)))
    (gf, gr, launches), (cf, cr, _) = out
    assert launches["bucket_pack"] == 32 and launches["fused_drain"] == 17
    assert torch.equal(gr.spikes.cpu(), cr.spikes)
    torch.testing.assert_close(gr.voltage.cpu(), cr.voltage, rtol=0,
                               atol=1e-5)
    for f in pc.CommStats._fields:
        if f != "utilization":
            assert torch.equal(getattr(gr.stats, f).cpu(),
                               getattr(cr.stats, f)), f
    assert torch.equal(gf.ring.ring.cpu(), cf.ring.ring)
    for name in ("flow", "sendq", "merge"):
        for a, b in zip(getattr(gf, name), getattr(cf, name)):
            assert torch.equal(a.cpu(), b), name
    assert int(cr.stats.sent.sum()) > 0
    assert int(cr.stats.stalled.sum()) + int(
        cf.sendq.occupancy().sum()) > 0


@pytest.mark.cuda
def test_lif_step_kernel_matches_plain(cuda):
    """Bitwise: the kernel rounds each operation as PyTorch's separate
    elementwise kernels do (no FMA contraction, expf)."""
    args = _lif_args(np.random.default_rng(0), (46, 512), cuda)
    before = kc.launches["lif_step"]
    got = lif.lif_step(*args)
    assert kc.launches["lif_step"] == before + 1
    for g, w in zip(got, lif_step_ref(*args)):
        assert torch.equal(g, w)
    # the network's neuron update goes through the same kernel
    state, spk = nr.lif_step(nr.LIFState(args[0], args[1]), args[2],
                             nr.LIFParams(*args[3:]))
    assert kc.launches["lif_step"] == before + 2
    assert torch.equal(spk, got[2]) and torch.equal(state.v, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["aligned", "ragged", "misaligned",
                                  "broadcast", "network"])
def test_lif_step_routes_match_plain(cuda, case):
    """Bitwise against the plain version at [46, 512], at [46, 511] (n not
    a multiple of the block), on a contiguous view one element into its
    storage (4-byte, not 16-byte aligned), with parameters of shape [512]
    broadcast against [46, 512], and on the network's call through
    ``snn.neuron.lif_step``.  Where every argument is ready (all but the
    broadcast case), the wrapper puts nothing on the card but the
    kernel."""
    rng = np.random.default_rng(len(case))
    shape = (46, 511) if case == "ragged" else (46, 512)
    args = list(_lif_args(rng, shape, cuda))
    if case == "misaligned":
        n = args[0].numel()
        base = torch.empty(n + 1, dtype=torch.float32, device=cuda)
        args[0] = base[..., 1:]
        args[0].copy_(_lif_args(rng, (n,), cuda)[0])
        shape = (n,)
        args[1:] = [x.reshape(-1) for x in args[1:]]
    if case == "broadcast":
        args[3:] = [x[0] for x in args[3:]]
    if case == "network":
        run = lambda: nr.lif_step(nr.LIFState(args[0], args[1]), args[2],
                                  nr.LIFParams(*args[3:]))
    else:
        run = lambda: lif.lif_step(*args)
    before = kc.launches["lif_step"]
    run()
    assert kc.launches["lif_step"] == before + 1
    got, names = kc.card_kernels(run)
    if case == "network":
        (state, spikes) = got
        got = (state.v, state.refrac, spikes)
    want = lif_step_ref(*(x.broadcast_to(shape) for x in args))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    kernels = [x for x in names if "lif_step_kernel" in x]
    assert len(kernels) == 1
    if case != "broadcast":
        assert names == kernels


def _sort_words(rng, lanes, kind, now):
    """Word rows of one kind: ``random`` (70% valid, deadlines within 40
    of each row's clock), ``sentinels`` (every word -1), ``equal`` (every
    valid word on one key, sentinels between) or ``negative`` (invalid
    words of any negative value, not only -1)."""
    shape = (N_CHIPS, lanes)
    addr = rng.integers(0, 1 << 14, shape)
    ahead = {"equal": np.full(shape, 7)}.get(kind, rng.integers(-40, 40,
                                                                 shape))
    valid = rng.random(shape) < (0.0 if kind == "sentinels" else 0.7)
    bad = (rng.integers(-2**31, 0, shape) if kind == "negative"
           else np.full(shape, -1))
    dead = now[:, None] + ahead
    return np.where(valid, (addr << 8) | (dead & 0xFF), bad).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,kind", [
    *((n, "random") for n in (1, 70, 127, 128, 129, 300, 3136, 32768)),
    (3136, "sentinels"), (3136, "equal"), (129, "negative"),
    (3136, "negative")])
def test_merge_sort_words_kernel_matches_plain(cuda, lanes, kind):
    rng = np.random.default_rng(lanes)
    now_np = np.array([0, 250, 255, 3, 128], np.int32)
    now = _on(now_np, cuda)
    words = _on(_sort_words(rng, lanes, kind, now_np), cuda)
    before = kc.launches["merge_sort_words"]
    got = ms.merge_sort_words(words, now)
    assert kc.launches["merge_sort_words"] == before + 1
    assert torch.equal(got, merge_sort_words_ref(words, now))
    # a merge cycle sorts the 16-slot queue, the words and 5 sentinels
    words = words[:, :ms.MAX_LANES["words"] - 21]
    buf = mg.merge_init(16, batch_shape=(N_CHIPS,), device=cuda)
    a = mg.merge_step_words(buf, words, now=now, rate=5, use_pallas=True)
    b = mg.merge_step_words(buf, words, now=now, rate=5)
    assert kc.launches["merge_sort_words"] == before + 2
    assert torch.equal(a[0].words, b[0].words) and torch.equal(a[1], b[1])


def _sort_soa(rng, lanes, kind):
    """SoA rows of one kind (keys ``valid ? deadline : 2^30``):
    ``mixed`` (a few values from the ends of int32 and around 2^30),
    ``full`` (uniform over int32: 4 radix passes), ``equal`` (one key
    throughout: 0 passes), ``sign`` (only bit 31 varies), ``one`` (a
    single lane differs) and ``tied`` (valid deadlines equal to 2^30
    among invalid lanes)."""
    shape = (N_CHIPS, lanes)
    addr = rng.integers(0, 1 << 14, shape)
    if kind == "mixed":
        dead = rng.choice([-2**31, -5, 0, 3, 2**30, 2**30 + 1, 2**31 - 1],
                          shape)
    elif kind == "full":
        dead = rng.integers(-2**31, 2**31, shape)
    elif kind == "equal":
        dead = np.full(shape, 12345)
    elif kind == "sign":
        dead = rng.choice([-2**31 + 77, 77], shape)
    elif kind == "one":
        dead = np.full(shape, -9)
        dead[:, rng.integers(0, lanes)] = -10
    else:
        dead = np.where(rng.random(shape) < 0.5, 2**30, 17)
    valid = rng.random(shape) < 0.6
    if kind in ("equal", "sign", "one"):
        valid[:] = True
    return (addr.astype(np.int32), dead.astype(np.int32), valid)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,kind", [
    *((n, "mixed") for n in (1, 300, 3136, 16384)),
    (3136, "full"), (16384, "full"), (3136, "equal"), (300, "sign"),
    (3136, "one"), (3136, "tied")])
def test_merge_sort_kernel_matches_plain(cuda, lanes, kind):
    """Negative deadlines and deadlines at and above 2^30, and the radix
    sort's cases: 4 passes, none, the sign bit alone, one lane apart."""
    rng = np.random.default_rng(lanes)
    addr, dead, valid = (_on(x, cuda) for x in _sort_soa(rng, lanes, kind))
    before = kc.launches["merge_sort"]
    got = ms.merge_sort(addr, dead, valid)
    assert kc.launches["merge_sort"] == before + 1
    for g, w in zip(got, merge_sort_ref(addr, dead, valid)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_merge_sort_kernels_refuse_rows_past_their_limits(cuda):
    words = torch.full((2, ms.MAX_LANES["words"] + 1), -1, dtype=torch.int32,
                       device=cuda)
    with pytest.raises(ValueError, match="32768 lanes"):
        ms.merge_sort_words(words, 0)
    lanes = ms.MAX_LANES["soa"] + 1
    addr = torch.zeros((2, lanes), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16384 lanes"):
        ms.merge_sort(addr, addr, addr.bool())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["simplified", "full"])
@pytest.mark.parametrize("b", [1, 8])
def test_fused_lif_inject_kernel_matches_plain(cuda, b, mode):
    rng = np.random.default_rng(b + len(mode))
    n = 700                                  # more neurons than one tile
    v, refrac, _, *params = _lif_args(rng, (N_CHIPS, n), cuda)
    currents = _on(rng.normal(0.5, 0.8, (b, N_CHIPS, n)).astype(np.float32),
                   cuda)
    table = rt.RoutingTable(
        _on(rng.integers(-1, N_CHIPS, (N_CHIPS, n, 1)).astype(np.int32),
            cuda),
        _on(rng.integers(0, n, (N_CHIPS, n, 1)).astype(np.int32), cuda),
        _on(rng.integers(b, 20, (N_CHIPS, n, 1)).astype(np.int32), cuda),
        _on(rng.random((N_CHIPS, n, 1)) < 0.9, cuda))
    t0 = _on(np.array([0, 100, 250, 254, 7], np.int32), cuda)
    kw = dict(event_capacity=200, n_chips=N_CHIPS, buckets_per_chip=2,
              capacity=16, mode=mode, time_window=4)
    lifp = nr.LIFParams(*params)
    before = kc.launches["fused_lif_inject"]
    got = fi.fused_lif_inject(v, refrac, currents, lifp, table, t0, **kw)
    assert kc.launches["fused_lif_inject"] == before + 1
    want = fused_lif_inject_ref(v, refrac, currents, lifp, table, t0, **kw)
    for name in ("v", "refrac", "spikes", "voltage"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    _equal(got.inject, want.inject)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["simplified", "full"])
@pytest.mark.parametrize("b", [1, 8])
def test_fused_lif_inject_tiles_and_cut_match_plain(cuda, b, mode):
    """N = 2000 neurons (four tiles of 512 for the LIF update, the
    compaction and the inject) and an event_capacity of 40, below the
    spikes of most substeps, so the cut bites; bitwise, one launch of the
    one kernel per call."""
    rng = np.random.default_rng(2000 + b + len(mode))
    n = 2000
    v, refrac, _, *params = _lif_args(rng, (N_CHIPS, n), cuda)
    currents = _on(rng.normal(0.5, 0.8, (b, N_CHIPS, n)).astype(np.float32),
                   cuda)
    table = rt.RoutingTable(
        _on(rng.integers(-1, N_CHIPS, (N_CHIPS, n, 1)).astype(np.int32),
            cuda),
        _on(rng.integers(0, n, (N_CHIPS, n, 1)).astype(np.int32), cuda),
        _on(rng.integers(b, 20, (N_CHIPS, n, 1)).astype(np.int32), cuda),
        _on(rng.random((N_CHIPS, n, 1)) < 0.9, cuda))
    t0 = _on(np.array([0, 100, 250, 254, 7], np.int32), cuda)
    kw = dict(event_capacity=40, n_chips=N_CHIPS, buckets_per_chip=2,
              capacity=16, mode=mode, time_window=4)
    lifp = nr.LIFParams(*params)
    run = lambda: fi.fused_lif_inject(v, refrac, currents, lifp, table, t0,
                                      **kw)
    before = kc.launches["fused_lif_inject"]
    run()
    assert kc.launches["fused_lif_inject"] == before + 1
    got, names = kc.card_kernels(run)
    assert len(names) == 1 and "fused_lif_inject_kernel" in names[0], names
    want = fused_lif_inject_ref(v, refrac, currents, lifp, table, t0, **kw)
    for name in ("v", "refrac", "spikes", "voltage"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for g, w in zip(got.inject, want.inject):
        assert torch.equal(g, w)
    assert int((want.spikes.sum(-1) > kw["event_capacity"]).sum()) > 0


@pytest.mark.cuda
def test_demo_on_the_card_matches_the_cpu(cuda):
    from repro_torch import demo
    from repro_torch.snn import network as net

    records = []
    for device in (cuda, torch.device("cpu")):
        cfg, params, state, ext = demo.setup(device)
        records.append(net.run(cfg, params, state, ext, device=device)[1])
    gpu, cpu = records
    assert torch.equal(gpu.spikes.cpu(), cpu.spikes)
    torch.testing.assert_close(gpu.voltage.cpu(), cpu.voltage, rtol=0,
                               atol=1e-5)


FLASH_SHAPES = [
    (1, 4, 4, 130, 190, 80, True, 0),
    (2, 8, 2, 200, 200, 128, True, 0),
    (1, 4, 2, 64, 192, 16, True, 128),
    (1, 2, 2, 100, 300, 64, False, 0),
    (1, 2, 1, 1, 77, 256, True, 76),
    (1, 3, 3, 65, 65, 8, True, 0)]
# The tensor-core kernels' edges, run in both types: head sizes that are
# not a multiple of 64 (TMA zero-fills the columns past D) or of 16 (the
# float32 instance skips the column blocks past D), a single key, a
# ragged q tile, GQA group 4.
FLASH_BF16_EDGES = [
    (1, 2, 2, 150, 150, 16, True, 0),
    (1, 2, 2, 150, 170, 72, True, 0),
    (1, 4, 4, 200, 200, 80, True, 0),
    (1, 2, 2, 150, 150, 96, False, 0),
    (1, 2, 2, 150, 170, 256, True, 0),
    (1, 4, 2, 5, 1, 64, False, 0),        # Skv = 1
    (1, 2, 2, 7, 1, 80, True, 20),
    (1, 4, 4, 129, 129, 80, True, 0),     # one row past a 128-row tile
    (2, 8, 2, 300, 300, 128, True, 0),    # GQA group 4
    (1, 8, 2, 129, 200, 80, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,d,causal,q_offset,dtype",
    [(*shape, dtype) for dtype in ("float32", "bfloat16")
     for shape in FLASH_SHAPES]
    + [(*shape, "bfloat16") for shape in FLASH_BF16_EDGES]
    + [(*shape, "float32") for shape in FLASH_BF16_EDGES])
def test_flash_attention_kernel_matches_plain(cuda, b, hq, hkv, sq, skv, d,
                                              causal, q_offset, dtype):
    """Within 2e-5 in float32 (3xTF32 keeps each product to about 2^-22
    of its size, and the sums run in another order); bfloat16 within the
    bound of :func:`_check_flash_bf16`."""
    q, k, v = _flash_inputs(cuda, b, hq, hkv, sq, skv, d,
                            getattr(torch, dtype))
    before = kc.launches["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert kc.launches["flash_attention"] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    if dtype == "bfloat16":
        _check_flash_bf16(got, q, k, v, causal=causal, q_offset=q_offset)
    else:
        want = attention_ref(q, k, v, causal=causal, q_offset=q_offset)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_flash_attention_f32_on_a_peaked_softmax(cuda):
    """Scores eight times larger (q x 8) in float32: 3xTF32's error grows
    with |s|, so the bound is 2^-20 max|s| max|v| (the design emulated on
    the CPU lands at a tenth of it, ``tests/test_torch_kernels_lm.py``)."""
    q, k, v = _flash_inputs(cuda, 2, 8, 2, 200, 200, 128, torch.float32)
    q = q * 8
    got = fa.flash_attention(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    kr = k.repeat_interleave(4, dim=1)
    max_s = float((q @ kr.transpose(-1, -2)).abs().max()) / 128 ** 0.5
    torch.testing.assert_close(got, want, rtol=0, atol=2**-20 * max_s
                               * float(v.abs().max()))


def _flash_inputs(device, b, hq, hkv, sq, skv, d, dtype):
    rng = np.random.default_rng(sq + skv + d)
    return tuple(_on(rng.standard_normal(shape).astype(np.float32),
                     device).to(dtype)
                 for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                               (b, hkv, skv, d)))


def _check_flash_bf16(got, q, k, v, **kw):
    """A bfloat16 output against the plain version in float32 on the same
    bfloat16 inputs: within 2^-8 |want| + 2^-8 max|v|, half a bf16 ulp of
    the output plus the kernel's rounding of P to bf16 before PV (at most
    2^-9 max|v|, doubled as l sums the unrounded p)."""
    want = attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(got.float(), want, rtol=2**-8,
                               atol=2**-8 * float(v.float().abs().max()))


@pytest.mark.cuda
def test_flash_attention_bf16_copies_a_misaligned_view(cuda):
    """TMA needs a 16-byte aligned base: a view whose storage offset is 2
    bytes is copied by the wrapper, and the result is the aligned one's."""
    q, k, v = _flash_inputs(cuda, 1, 2, 2, 70, 90, 64, torch.bfloat16)
    flat = torch.empty(k.numel() + 1, dtype=torch.bfloat16, device=cuda)
    flat[1:] = k.reshape(-1)
    k_view = flat[1:].view(k.shape)
    assert k_view.data_ptr() % fa.TMA_ALIGN != 0
    got = fa.flash_attention(q, k_view, v)
    assert torch.equal(got, fa.flash_attention(q, k, v))
    _check_flash_bf16(got, q, k, v)


def _scan_a(rng, din, n, kind, head=80):
    """A [din, n]: "general" (random per element), "per_head" (Mamba-2: one
    value per head of `head` channels, broadcast over the states, as the
    model's _dt_bc builds it) or "mixed" (per-head rows at even channels,
    general rows at odd ones, so one block holds both)."""
    general = -np.exp(rng.standard_normal((din, n)) * 0.5)
    a_h = -np.exp(rng.standard_normal(-(-din // head)) * 0.5)
    per_head = np.repeat(a_h, head)[:din, None] * np.ones((1, n))
    if kind == "general":
        return general
    if kind == "per_head":
        return per_head
    return np.where((np.arange(din) % 2 == 0)[:, None], per_head, general)


def _scan_args(device, b, t, din, n, kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, din))
    dt = np.log1p(np.exp(rng.standard_normal((b, t, din)) - 1.0))
    a = _scan_a(rng, din, n, kind)
    return [_on(z.astype(np.float32), device) for z in (
        x, dt, a, rng.standard_normal((b, t, n)),
        rng.standard_normal((b, t, n)), rng.standard_normal(din))]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["general", "per_head", "mixed"])
@pytest.mark.parametrize("b,t,din,n", [(2, 130, 100, 8), (1, 64, 256, 64),
                                       (2, 300, 200, 16), (1, 40, 5120, 64),
                                       (1, 33, 70, 100),
                                       (1, 40, 96, scan.MAX_STATE)])
def test_ssm_scan_kernel_matches_plain(cuda, b, t, din, n, kind):
    """y and the final state within 1e-4 (relative and absolute): the
    card's expf and sums over the state in another order.  T not a
    multiple of the tile, di not a multiple of the block, N from 8 to
    MAX_STATE, and A general, per head (one exp per channel and step) or
    both within one block."""
    args = _scan_args(cuda, b, t, din, n, kind, t + din + n)
    before = kc.launches["ssm_scan"]
    y, h = scan.ssm_scan(*args)
    assert kc.launches["ssm_scan"] == before + 1
    want_y, want_h = ssm_scan_ref(*args)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,din,n", [(1, 64, 256, 64), (2, 37, 75, 16),
                                       (1, 20, 34, 64)])
def test_ssm_scan_kernel_reads_bf16_x_as_its_f32_upcast(cuda, b, t, din, n):
    """A bf16 x gives bitwise the output of the same x upcast to f32 (the
    kernel reads bf16 in place; bf16 to f32 is exact).  di 75 and 34 give
    rows that are not 4- and 16-byte aligned."""
    args = _scan_args(cuda, b, t, din, n, "per_head", 5 + din)
    xb = args[0].to(torch.bfloat16)
    before = kc.launches["ssm_scan"]
    got = scan.ssm_scan(xb, *args[1:])
    want = scan.ssm_scan(xb.float(), *args[1:])
    assert kc.launches["ssm_scan"] == before + 2
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    torch.testing.assert_close(got[0], ssm_scan_ref(xb, *args[1:])[0],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("din,n", [(256, 64), (100, 16)])
def test_ssm_scan_constant_row_ignores_its_neighbours(cuda, din, n):
    """A constant row of A gives bitwise the same y and final state
    whether the other rows of its block are constant or general."""
    args = _scan_args(cuda, 2, 50, din, n, "per_head", din)
    mixed = list(args)
    mixed[2] = _on(_scan_a(np.random.default_rng(din), din, n, "general")
                   .astype(np.float32), cuda)
    mixed[2][::2] = args[2][::2]
    y0, h0 = scan.ssm_scan(*args)
    y1, h1 = scan.ssm_scan(*mixed)
    assert torch.equal(y0[..., ::2], y1[..., ::2])
    assert torch.equal(h0[:, ::2], h1[:, ::2])
    assert not torch.equal(y0[..., 1::2], y1[..., 1::2])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "internlm2-1.8b"])
def test_reduced_serve_on_the_card_matches_the_cpu(cuda, arch):
    """Prefill and two decode steps of a reduced config: the kernels on
    the card against the plain versions on the CPU, logits within 2e-4
    (prefill) and 5e-4 (decode), the bounds of the CPU parity with JAX."""
    from repro_torch import configs as C
    from repro_torch.models import lm
    from repro_torch.models import spec as sp

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = C.get(arch).reduced()
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 70)).astype(np.int32))
    out = {}
    for device in (cuda, torch.device("cpu")):
        p = sp.tree_map(lambda x: x.to(device), params)
        tk = tokens.to(device)
        kc.reset_launches()
        last, cache = lm.prefill(cfg, p, {"tokens": tk[:, :68]})
        counts = dict(kc.launches)
        cache = lm.pad_cache(cfg, cache, 70)
        steps = [last]
        for i in (68, 69):
            lg, cache = lm.decode(cfg, p, tk[:, i], cache, i)
            steps.append(lg)
        out[device.type] = (torch.stack(steps).cpu(), counts)
    (gpu, counts), (cpu, _) = out["cuda"], out["cpu"]
    attn_layers = cfg.attn_layers
    assert counts["flash_attention"] == attn_layers
    assert counts["ssm_scan"] == (cfg.n_layers if cfg.ssm_state else 0)
    torch.testing.assert_close(gpu[0], cpu[0], rtol=0, atol=2e-4)
    torch.testing.assert_close(gpu[1:], cpu[1:], rtol=0, atol=5e-4)


def _drill_setup(device, telemetry=True):
    """An 8-chip network (2 x 4 torus, 32 LIF a chip, fan-out 1, full mode,
    2 buckets a chip) with telemetry, its params from a seed."""
    import dataclasses

    from repro_torch import obs
    from repro_torch.core import pulse_comm as pc
    from repro_torch.core import topology as tpo
    from repro_torch.snn import network as net

    comm = pc.PulseCommConfig(n_chips=8, neurons_per_chip=32,
                              n_inputs_per_chip=32, event_capacity=32,
                              bucket_capacity=8, buckets_per_chip=2,
                              ring_depth=32, mode="full", merge_rate=4)
    cfg = net.NetworkConfig(
        comm=comm, topology=tpo.torus2d(2, 4, link_latency=1),
        telemetry=obs.MetricsConfig(flight_depth=4) if telemetry else None)
    gen = torch.Generator().manual_seed(5)
    table = rt.random_table(gen, 32, 8, min_delay=4, max_delay=10)
    params = net.init_params(gen, cfg, table=table, device="cpu")
    to = lambda x: type(x)(*(v.to(device) for v in x))  # noqa: E731
    params = type(params)(*(to(x) for x in params))
    return dataclasses, net, cfg, params


def _run_drill(device, tmp_path, failures, t_total=14):
    from repro_torch import checkpoint as ckpt
    from repro_torch.core import resilience as rsl
    from repro_torch.runtime import ResilientRunner

    dataclasses, net, cfg, params = _drill_setup(device)
    rng = np.random.default_rng(9)
    ext = torch.from_numpy((1.5 * (rng.random((t_total, 8, 32)) < 0.3))
                           .astype(np.float32)).to(device)
    injector = rsl.FabricFaultInjector(n_chips=8, chip_failures=failures)

    def make_step(healthy):
        hcfg = dataclasses.replace(cfg, healthy=tuple(healthy))

        def step_fn(state, t):
            alive = injector.alive_at(t, device=device)
            new, rec = net.step(hcfg, params, state, ext[t] * alive[:, None],
                                device=device)
            fzn, fzr = rsl.freeze(alive, (state.neuron, state.ring),
                                  (new.neuron, new.ring))
            return new._replace(neuron=fzn, ring=fzr), rec._replace(
                spikes=rec.spikes * alive[:, None].float())
        return step_fn

    def detect(state, t, healthy):
        surviving = tuple(c for c in injector.healthy_after(t)
                          if c in healthy)
        return surviving if surviving != tuple(healthy) else None

    (tmp_path / "flight").mkdir(parents=True)
    runner = ResilientRunner(
        make_step=make_step, detect=detect, ckpt_dir=str(tmp_path / "ckpt"),
        n_chips=8, ckpt_every=3, flight_of=lambda s: s.metrics.flight,
        flight_dir=str(tmp_path / "flight"))
    final, healthy = runner.run(net.init_state(cfg, params, device=device),
                                t_total)
    return runner, final, healthy, ckpt


@pytest.mark.cuda
def test_resilient_drill_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Chips 3 and 6 of 8 die at steps 5 and 9 under ResilientRunner: the
    card's drill launches the fabric's kernels and gives the CPU's
    recoveries, records (spikes, every integer stat), final state
    (integers bitwise, floats within 1e-5) and flight dumps."""
    from repro_torch import obs

    failures = ((3, 5), (6, 9))
    kc.reset_launches()
    card = _run_drill(cuda, tmp_path / "card", failures)
    for k in ("fused_inject", "fused_drain", "lif_step"):
        assert kc.launches[k] > 0, k
    cpu = _run_drill(torch.device("cpu"), tmp_path / "cpu", failures)
    runner, final, healthy, ckpt = card
    assert healthy == (0, 1, 2, 4, 5, 7)
    assert [tuple(r)[:2] for r in runner.recoveries] == [(5, 3), (9, 9)]
    assert runner.recoveries == cpu[0].recoveries
    assert sorted(runner.records) == list(range(14))
    for t, rec in runner.records.items():
        want = cpu[0].records[t]
        assert torch.equal(rec.spikes.cpu(), want.spikes), t
        for f in rec.stats._fields:
            if f != "utilization":
                assert torch.equal(getattr(rec.stats, f).cpu(),
                                   getattr(want.stats, f)), (t, f)
    assert sum(int(r.stats.lost_to_failure.sum())
               for r in runner.records.values()) > 0
    for a, b in zip(ckpt.tree_leaves(final), ckpt.tree_leaves(cpu[1])):
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-5)
        else:
            assert torch.equal(a.cpu(), b)
    assert len(runner.flight_dumps) == 2
    for p, q in zip(runner.flight_dumps, cpu[0].flight_dumps):
        assert obs.load_flight(p) == obs.load_flight(q)


@pytest.mark.cuda
def test_telemetry_on_equals_off_on_the_card(cuda):
    """Telemetry on against off on the card: spikes, ring and every stat
    equal; the carry equals the CPU's; ``metrics_update`` makes no host
    sync (CUDA sync debug mode set to error around it)."""
    from repro_torch import checkpoint as ckpt
    from repro_torch import obs

    dataclasses, net, cfg, params = _drill_setup(cuda)
    cfg = dataclasses.replace(cfg, comm=dataclasses.replace(cfg.comm,
                                                            superstep=4))
    off = dataclasses.replace(cfg, telemetry=None)
    rng = np.random.default_rng(3)
    ext = torch.from_numpy((1.5 * (rng.random((16, 8, 32)) < 0.3))
                           .astype(np.float32))
    outs = {}
    for name, c, dev in (("off", off, cuda), ("on", cfg, cuda),
                         ("cpu", cfg, torch.device("cpu"))):
        p = type(params)(*(type(x)(*(v.to(dev) for v in x)) for x in params))
        outs[name] = net.run(c, p, net.init_state(c, p, device=dev),
                             ext.to(dev), device=dev)
    (foff, roff), (fon, ron), (fcpu, _) = outs["off"], outs["on"], outs["cpu"]
    assert torch.equal(roff.spikes, ron.spikes)
    assert torch.equal(foff.ring.ring, fon.ring.ring)
    for f in roff.stats._fields:
        assert torch.equal(getattr(roff.stats, f), getattr(ron.stats, f)), f
    for a, b in zip(ckpt.tree_leaves(fon.metrics),
                    ckpt.tree_leaves(fcpu.metrics)):
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-30)
        else:
            assert torch.equal(a.cpu(), b)
    assert obs.metrics_summary(fon.metrics)["totals"]["sent"] == \
        int(ron.stats.sent.sum()) > 0

    stats = type(ron.stats)(*(x[:4] for x in ron.stats))
    m = obs.metrics_update(obs.MetricsConfig(flight_depth=4), fon.metrics,
                           stats, merge=fon.merge)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m = obs.metrics_update(obs.MetricsConfig(flight_depth=4), m, stats,
                               merge=fon.merge)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(m.blocks) == int(fon.metrics.blocks) + 2
