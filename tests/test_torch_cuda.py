"""The port's CUDA kernels against their plain PyTorch versions on the
card (the SNN kernels bitwise, flash attention, its backward, the SSM
scan and its backward within a stated tolerance), the feedforward demo,
a reduced LM serve (float32 and bf16) and reduced training steps (the
dense model's, and zamba2's Mamba block) on the card against the CPU.

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
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_bounds, attention_bwd_ref, attention_ref,
    attention_with_lse_ref, tf32x3_bwd_bounds)
from repro_torch.kernels.lif_step import ops as lif
from repro_torch.kernels.lif_step.ref import lif_step_ref
from repro_torch.kernels.merge_sort import ops as ms
from repro_torch.kernels.merge_sort.ref import merge_sort_ref, merge_sort_words_ref
from repro_torch.kernels.ssm_scan import ops as scan
from repro_torch.kernels.ssm_scan.ref import (heads_to_channels,
                                              ssm_scan_bwd_ref,
                                              ssm_scan_heads_bwd_ref,
                                              ssm_scan_ref,
                                              ssm_scan_with_states_ref)
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
    got, names = kc.card_kernels(run, expect="fused_inject_kernel")
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
    got, names = kc.card_kernels(run, expect="fused_inject_kernel")
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
@pytest.mark.parametrize("mode", ["simplified", "full"])
@pytest.mark.parametrize("reach", ["reach", "none"])
def test_fused_inject_on_a_rank_s_rows_matches_plain(cuda, mode, reach):
    """The shard forms' call: 3 of 5 chips (rows 2 to 4, the reach rows
    [2:5]), ``n_rows`` 3 against ``n_chips`` 5 destinations, bitwise
    against the plain version and against rows 2 to 4 of the 5-row
    call."""
    events, table, t0 = _inject_block(np.random.default_rng(11), 8, 512,
                                      "in_range", cuda)
    full_reach = _reach(cuda) if reach == "reach" else None
    kw = dict(n_chips=N_CHIPS, buckets_per_chip=2, capacity=8, mode=mode,
              time_window=4)
    rows = slice(2, N_CHIPS)
    part = (ev.EventBuffer(*(x[:, rows].contiguous() for x in events)),
            rt.RoutingTable(*(x[rows].contiguous() for x in table)),
            t0[rows].contiguous())
    part_reach = None if full_reach is None else full_reach[rows].contiguous()
    got = fi.fused_inject(*part, reach=part_reach, **kw)
    want = fused_inject_ref(*part, reach=part_reach, **kw)
    whole = fi.fused_inject(events, table, t0, reach=full_reach, **kw)
    assert got.traffic.shape == (8, 3, N_CHIPS)
    for name, g, w, h in zip(got._fields, got, want, whole):
        assert torch.equal(g, w), name
        h = h[rows] if name == "slab" else h[:, rows]
        assert torch.equal(g, h), name


@pytest.mark.cuda
def test_fused_lif_inject_on_a_rank_s_rows_matches_plain(cuda):
    """``fused_lif_inject`` at ``n_rows`` 3 of 5 chips with the reach
    rows, bitwise against the plain version and the 5-row call's rows."""
    rng = np.random.default_rng(5)
    n = 300
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
    kw = dict(event_capacity=200, n_chips=N_CHIPS, buckets_per_chip=2,
              capacity=16, mode="full", time_window=4)
    rows = slice(2, N_CHIPS)
    cut = lambda x: x[rows].contiguous()  # noqa: E731
    args = (cut(v), cut(refrac), currents[:, rows].contiguous(),
            nr.LIFParams(*(cut(x) for x in params)),
            rt.RoutingTable(*(cut(x) for x in table)), cut(t0))
    reach = _reach(cuda)
    got = fi.fused_lif_inject(*args, reach=cut(reach), **kw)
    want = fused_lif_inject_ref(*args, reach=cut(reach), **kw)
    whole = fi.fused_lif_inject(v, refrac, currents, nr.LIFParams(*params),
                                table, t0, reach=reach, **kw)
    for name in ("v", "refrac"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(getattr(got, name), getattr(whole, name)[rows])
    for name in ("spikes", "voltage"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert torch.equal(getattr(got, name),
                           getattr(whole, name)[:, rows]), name
    for name, g, w, h in zip(got.inject._fields, got.inject, want.inject,
                             whole.inject):
        assert torch.equal(g, w), name
        assert torch.equal(g, h[rows] if name == "slab" else h[:, rows]), name


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
    got, names = kc.card_kernels(run, expect="bucket_pack_kernel")
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
    got, names = kc.card_kernels(run, expect="fused_lif_inject_kernel")
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
    (1, 3, 3, 65, 65, 8, True, 0),
    (1, 16, 16, 1500, 1500, 64, False, 0),  # whisper's encoder: 1500
    (1, 16, 16, 8, 1500, 64, False, 0)]     # frames; its cross-attention
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
    (1, 8, 2, 129, 200, 80, True, 0),
    (1, 16, 2, 129, 200, 128, True, 0)]   # GQA group 8 (yi-9b's, chameleon's)


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


# Windowed flash shapes: (b, hq, hkv, sq, skv, d, causal, q_offset, window),
# the ragged case of chip_smoke.py (Sq 777, Skv 1000, q_offset 223, window
# 100, GQA 2) with and without the causal mask, a window below a tile,
# and rows past their window's keys without the mask (those give 0).
WINDOW_SHAPES = [
    (1, 8, 4, 777, 1000, 80, True, 223, 100),
    (1, 8, 4, 777, 1000, 80, False, 223, 100),
    (2, 4, 2, 300, 300, 64, True, 0, 7),
    (1, 4, 4, 200, 130, 128, False, 60, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,q_offset,window",
                         WINDOW_SHAPES)
def test_flash_attention_window_matches_plain(cuda, b, hq, hkv, sq, skv, d,
                                              causal, q_offset, window,
                                              dtype):
    """The sliding window in both forward routes against the plain
    version (float32 within 2e-5, bfloat16 within
    :func:`_check_flash_bf16`'s bound); one ``flash_attention`` kernel a
    call (torch.profiler), two calls the same bits."""
    q, k, v = _flash_inputs(cuda, b, hq, hkv, sq, skv, d,
                            getattr(torch, dtype))
    kw = dict(causal=causal, q_offset=q_offset, window=window)
    before = kc.launches["flash_attention"]
    got, names = kc.card_kernels(lambda: fa.flash_attention(q, k, v, **kw),
                                 expect="flash_attention")
    assert kc.launches["flash_attention"] > before
    assert len(names) == 1 and "flash_attention" in names[0], names
    assert torch.equal(got, fa.flash_attention(q, k, v, **kw))
    if dtype == "bfloat16":
        _check_flash_bf16(got, q, k, v, **kw)
    else:
        torch.testing.assert_close(got, attention_ref(q, k, v, **kw), rtol=0,
                                   atol=2e-5)


@pytest.mark.cuda
def test_flash_attention_window_refuses_a_gradient(cuda):
    q, k, v = (x.requires_grad_() for x in _flash_inputs(
        cuda, 1, 2, 2, 64, 64, 64, torch.bfloat16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fa.flash_attention(q, k, v, window=16)


def _ssd_inputs(device, b, t, nh, n, dtype, with_h0):
    rng = np.random.default_rng(b + t + nh + n)
    f = lambda *s: _on(rng.standard_normal(s).astype(np.float32),  # noqa: E731
                       device)
    di = nh * 64
    return (f(b, t, di).to(dtype),
            torch.nn.functional.softplus(f(b, t, nh) - 1.0),
            -torch.exp(f(nh) * 0.5), f(b, t, n), f(b, t, n), f(di),
            f(b, di, n) if with_h0 else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,nh,n,chunk,with_h0", [
    (2, 130, 10, 64, 128, True),     # ragged, a nonzero initial state
    (1, 300, 4, 64, 64, False),      # the serve-check's chunk
    (1, 50, 2, 64, 256, True),       # t < chunk
    (2, 512, 3, 48, 256, False),     # N below 64
    (1, 200, 2, 64, 100, True)])     # a chunk that is no multiple of 16
def test_ssd_chunked_kernel_matches_plain(cuda, b, t, nh, n, chunk, with_h0,
                                          dtype):
    """``ssd_chunked`` against ``ssd_chunked_ref`` on the same inputs:
    within 2^-7 (bf16: the same roundings of the same exact products, a
    flip of one an ulp of a term; a bf16 ulp of the element too) or 1e-4
    (f32, 3xTF32) of each output's largest; one launch of each of its
    three kernels a call (torch.profiler), one count; two calls the same
    bits."""
    from repro_torch.kernels.ssd import ops as ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    args = _ssd_inputs(cuda, b, t, nh, n, getattr(torch, dtype), with_h0)
    before = kc.launches["ssd_chunked"]
    (y, h), names = kc.card_kernels(
        lambda: ssd.ssd_chunked(*args, chunk=chunk), expect="ssd_scan_kernel")
    assert kc.launches["ssd_chunked"] == before + 2   # warm-up and call
    assert len(names) == 3 and all(
        sum(k in n_ for n_ in names) == 1
        for k in ("ssd_state_kernel", "ssd_pass_kernel", "ssd_scan_kernel")
    ), names
    y2, h2 = ssd.ssd_chunked(*args, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    wy, wh = ssd_chunked_ref(*args, chunk=chunk)
    assert y.dtype == wy.dtype and h.dtype == torch.float32
    frac = 2.0 ** -7 if dtype == "bfloat16" else 1e-4
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    for got, want in ((y, wy), (h, wh)):
        diff = (got.double() - want.double()).abs()
        ref = want.double().abs()
        assert bool((diff <= frac * float(ref.max()) + ulp * ref).all()), (
            float(diff.max()), float(ref.max()))


@pytest.mark.cuda
def test_ssd_chunked_refuses_other_shapes_and_a_gradient(cuda):
    from repro_torch.kernels.ssd import ops as ssd

    args = _ssd_inputs(cuda, 1, 40, 2, 64, torch.bfloat16, False)
    with pytest.raises(ValueError, match="heads of 64"):
        ssd.ssd_chunked(args[0][..., :96], args[1], args[2], *args[3:5],
                        args[5][:96], chunk=32)
    with pytest.raises(ValueError, match="chunks of 1 to 256"):
        ssd.ssd_chunked(*args, chunk=512)
    x = args[0].float().requires_grad_()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ssd.ssd_chunked(x, *args[1:], chunk=32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,q_offset",
                         FLASH_BF16_EDGES[:5] + [FLASH_BF16_EDGES[6],
                                                 FLASH_BF16_EDGES[8]])
def test_flash_attention_lse_matches_plain(cuda, b, hq, hkv, sq, skv, d,
                                           causal, q_offset, dtype):
    """The forward with lse: its output equals the call without lse
    bitwise, and lse lies within 1e-4 + 1e-5 |lse| of the plain version's
    on the same inputs in float32 (the scores are exact products summed
    in another order; the bf16 kernel's exp2 is the MUFU approximation,
    2 ulp, and it rescales from the log2 domain; 3xTF32's scores lie
    within 2^-20 max|s|)."""
    q, k, v = _flash_inputs(cuda, b, hq, hkv, sq, skv, d,
                            getattr(torch, dtype))
    kw = dict(causal=causal, q_offset=q_offset)
    before = kc.launches["flash_attention"]
    out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True, **kw)
    assert kc.launches["flash_attention"] == before + 1
    assert torch.equal(out, fa.flash_attention(q, k, v, **kw))
    _, want = attention_with_lse_ref(q.float(), k.float(), v.float(), **kw)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, sq)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-4)


FLASH_BWD_SHAPES = [
    (1, 2, 2, 150, 150, 16, True, 0),
    (1, 2, 1, 33, 50, 8, True, 17),       # D 8: columns past D are zero
    (1, 4, 4, 200, 200, 80, True, 0),     # zamba2's head size
    (2, 16, 8, 512, 512, 128, True, 0),   # internlm2's training heads
    (1, 8, 2, 129, 200, 80, True, 71),    # GQA 4, a chunk after 71 keys
    (1, 2, 2, 100, 120, 96, False, 0),
    (1, 4, 2, 5, 1, 64, False, 0),        # Skv = 1
    (1, 4, 4, 64, 64, 192, True, 0),
    (1, 2, 2, 150, 170, 256, True, 0),
    (1, 32, 32, 512, 512, 80, True, 0),   # zamba2's training heads
    (1, 32, 8, 129, 200, 80, True, 71),   # the same, GQA 4, 71 keys on
    (1, 16, 16, 448, 1500, 64, False, 0),  # whisper's cross-attention
    (1, 16, 16, 1500, 1500, 64, False, 0),  # and its encoder, training
    (1, 16, 2, 129, 200, 128, True, 0),   # GQA group 8, a ragged q tile
    (1, 64, 8, 129, 129, 128, True, 0)]   # chameleon-34b's 64 heads over 8


def _bwd_inputs(device, b, hq, hkv, sq, skv, d, dtype, causal, q_offset):
    """q, k, v, dout, and the plain forward's out and lse on them."""
    q, k, v = _flash_inputs(device, b, hq, hkv, sq, skv, d, dtype)
    dout = _on(np.random.default_rng(d).standard_normal((b, hq, sq, d))
               .astype(np.float32), device).to(dtype)
    out, lse = attention_with_lse_ref(q, k, v, causal=causal,
                                      q_offset=q_offset)
    return q, k, v, out, lse, dout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,q_offset",
                         FLASH_BWD_SHAPES)
def test_flash_attention_bwd_kernel_matches_plain(cuda, b, hq, hkv, sq, skv,
                                                  d, causal, q_offset, dtype):
    """dq, dk and dv of the two backward kernels against
    ``attention_bwd_ref`` on the same (q, k, v, out, lse, dout), elementwise
    within ``attention_bwd_bounds`` (bf16: a flip of the output's
    rounding, 2^-7 |y|, plus 2^-6 of the root of the sum of squared terms
    for flips of p's and ds's roundings, plus 2^-15 of a sum that bounds
    dp - delta; float32: 2^-16 of that sum, f32 sums in another order
    and products in 3xTF32); one count per call."""
    args = _bwd_inputs(cuda, b, hq, hkv, sq, skv, d, getattr(torch, dtype),
                       causal, q_offset)
    kw = dict(causal=causal, q_offset=q_offset)
    before = kc.launches["flash_attention_bwd"]
    got = fa.flash_attention_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert kc.launches["flash_attention_bwd"] == before + 1
    want = attention_bwd_ref(*args, **kw)
    bounds = attention_bwd_bounds(*args, **kw)
    for name, g, w, bound in zip(("dq", "dk", "dv"), got, want, bounds):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err = (g.float() - w.float()).abs()
        assert bool((err <= bound).all()), (
            f"{name}: max err {float(err.max())}, bound there "
            f"{float(bound.flatten()[err.argmax()])}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_trains_through_the_kernels(cuda, dtype):
    """Inputs that require grad go through the autograd Function: one
    forward launch that writes lse, one backward call whose gradients are
    the backward kernels' on the saved (q, k, v, out, lse); without grad
    the same output comes from the single launch without lse."""
    q, k, v = (x.requires_grad_(True) for x in _flash_inputs(
        cuda, 2, 8, 2, 300, 300, 128, getattr(torch, dtype)))
    dout = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(
        1), device=cuda).to(q.dtype)
    kc.reset_launches()
    out = fa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    assert (kc.launches["flash_attention"],
            kc.launches["flash_attention_bwd"]) == (1, 1)
    with torch.no_grad():
        plain_out = fa.flash_attention(q, k, v, causal=True)
        _, lse = fa.flash_attention_fwd(q, k, v, causal=True, with_lse=True)
        want = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True)
    assert torch.equal(out.detach(), plain_out)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (4, 16, 8, 512, 128),   # internlm2's training heads
    (2, 16, 4, 300, 80)])   # D 80, GQA 4
def test_flash_attention_bwd_bf16_is_deterministic(cuda, b, hq, hkv, s, d):
    """The bf16 backward uses no atomics: two calls on the same inputs
    give bitwise equal dq, dk and dv."""
    args = _bwd_inputs(cuda, b, hq, hkv, s, s, d, torch.bfloat16, True, 0)
    assert fa.design(torch.bfloat16, backward=True) == "mma_bf16"
    first = fa.flash_attention_bwd(*args)
    second = fa.flash_attention_bwd(*args)
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [448, 1500])
def test_flash_attention_bwd_without_the_mask_is_deterministic(cuda, sq,
                                                               dtype):
    """Without the causal mask, at whisper's training shapes (448 decoder
    rows or 1500 frames over 1500 frames, a ragged last key tile, 16 heads
    of 64): two calls on the same inputs give bitwise equal dq, dk and
    dv."""
    args = _bwd_inputs(cuda, 1, 16, 16, sq, 1500, 64, getattr(torch, dtype),
                       False, 0)
    first = fa.flash_attention_bwd(*args, causal=False)
    second = fa.flash_attention_bwd(*args, causal=False)
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.cuda
def test_flash_attention_bwd_f32_on_a_peaked_softmax(cuda):
    """q eight times larger in float32 (scores of tens): 3xTF32's error of
    s, which p passes on, grows with the scores, so the bound is
    ``tf32x3_bwd_bounds`` (``attention_bwd_bounds`` plus that share)."""
    q, k, v, out, lse, dout = _bwd_inputs(cuda, 1, 16, 8, 512, 512, 128,
                                          torch.float32, True, 0)
    q = q * 8
    out, lse = attention_with_lse_ref(q, k, v, causal=True)
    args = (q, k, v, out, lse, dout)
    got = fa.flash_attention_bwd(*args, causal=True)
    want = attention_bwd_ref(*args, causal=True)
    for name, g, w, bound in zip(("dq", "dk", "dv"), got, want,
                                 tf32x3_bwd_bounds(*args, causal=True)):
        err = (g - w).abs()
        assert bool((err <= bound).all()), (
            f"{name}: max err {float(err.max())}, bound there "
            f"{float(bound.flatten()[err.argmax()])}")


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 16, 8, 512, 128),   # internlm2's training heads, batch 1
    (2, 16, 4, 300, 80)])   # D 80, GQA 4
def test_flash_attention_bwd_f32_is_deterministic(cuda, b, hq, hkv, s, d):
    """The float32 backward uses no atomics either: two calls on the same
    inputs give bitwise equal dq, dk and dv."""
    assert fa.design(torch.float32, backward=True) == "mma_tf32x3"
    args = _bwd_inputs(cuda, b, hq, hkv, s, s, d, torch.float32, True, 0)
    first = fa.flash_attention_bwd(*args)
    second = fa.flash_attention_bwd(*args)
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


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


def _bwd_case(device, b, t, din, n, kind, seed, dh=True):
    """The scan's inputs of ``_scan_args``, its checkpoints from the plain
    forward, and dy (and dh_final) from the same seed."""
    args = _scan_args(device, b, t, din, n, kind, seed)
    _, _, hc = ssm_scan_with_states_ref(*args)
    rng = np.random.default_rng(seed + 1)
    dy = _on(rng.standard_normal((b, t, din)).astype(np.float32), device)
    dhf = (_on(rng.standard_normal((b, din, n)).astype(np.float32), device)
           if dh else None)
    return args, hc, dy, dhf


def _check_bwd(got, want, tol=1e-4):
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=tol * float(w.float().abs().max()),
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["general", "per_head", "mixed"])
@pytest.mark.parametrize("b,t,din,n", [(2, 130, 100, 8), (1, 64, 256, 64),
                                       (2, 300, 200, 16), (1, 40, 5120, 64),
                                       (1, 33, 70, 100),
                                       (1, 40, 96, scan.MAX_STATE),
                                       (1, 65, 70, 16), (1, 128, 96, 32),
                                       (1, 1000, 48, 16), (2, 64, 130, 4),
                                       (1, 40, 8192, 16)])
def test_ssm_scan_bwd_kernel_matches_plain(cuda, b, t, din, n, kind):
    """``ssm_scan_bwd`` (one launch) against ``ssm_scan_bwd_ref`` on the
    card, each gradient within 1e-4 of its largest |.| (the forward's
    bound: the card's expf, and sums in another order: dB and dC over up
    to 8192 channels, du and q . A over up to 512 states, dA and dD over
    the batch and the steps, the states recomputed from the checkpoints
    along 64 steps, g carried back across up to 15 chunks), over the
    forward's shapes and both forms of the backward (the chunk form up to
    N 64, the walk form above): T short of a chunk, at one (64, 128),
    one step past one (65) and over many (1000), di not a multiple of
    the block's channels (70, 100, 130), falcon-mamba's width (8192) at
    a short T, N from 4 to MAX_STATE, A general, per head or both in a
    block."""
    args, hc, dy, dh = _bwd_case(cuda, b, t, din, n, kind, t + din + n)
    before = kc.launches["ssm_scan_bwd"]
    got = scan.ssm_scan_bwd(*args, hc, dy, dh)
    assert kc.launches["ssm_scan_bwd"] == before + 1
    _check_bwd(got, ssm_scan_bwd_ref(*args, hc, dy, dh))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,din,n", [(1, 64, 256, 64), (2, 37, 75, 16),
                                       (1, 20, 34, 64)])
def test_ssm_scan_bwd_reads_bf16_x_as_its_f32_upcast(cuda, b, t, din, n):
    """A bf16 x gives bitwise the gradients of the same x upcast to f32,
    dx rounded once to bf16 (the kernel reads bf16 in place and rounds dx
    to nearest even, as ``Tensor.to`` does).  di 75 and 34 give rows
    that are not 4- and 16-byte aligned."""
    args, hc, dy, dh = _bwd_case(cuda, b, t, din, n, "per_head", 5 + din)
    xb = args[0].to(torch.bfloat16)
    got = scan.ssm_scan_bwd(xb, *args[1:], hc, dy, dh)
    want = scan.ssm_scan_bwd(xb.float(), *args[1:], hc, dy, dh)
    assert got[0].dtype == torch.bfloat16
    assert torch.equal(got[0], want[0].to(torch.bfloat16))
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,din,n", [(2, 130, 100, 64), (1, 70, 48, 16)])
def test_ssm_scan_bwd_takes_the_final_state_gradient(cuda, b, t, din, n):
    """A nonzero dh_final enters the walk at the last step: the kernel
    matches the plain version with it (1e-4, as above), and differs from
    its own result without it (None, which is 0)."""
    args, hc, dy, dh = _bwd_case(cuda, b, t, din, n, "mixed", din + n)
    got = scan.ssm_scan_bwd(*args, hc, dy, dh)
    _check_bwd(got, ssm_scan_bwd_ref(*args, hc, dy, dh))
    zero = scan.ssm_scan_bwd(*args, hc, dy, None)
    for g, w in zip(zero, scan.ssm_scan_bwd(*args, hc, dy,
                                            torch.zeros_like(dh))):
        assert torch.equal(g, w)
    assert not torch.equal(got[2], zero[2])


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,din,n,kind", [(4, 512, 5120, 64, "per_head"),
                                            (2, 130, 100, 16, "mixed"),
                                            (4, 512, 8192, 16, "general"),
                                            (1, 1000, 100, 16, "mixed"),
                                            (1, 130, 70, 100, "mixed")])
def test_ssm_scan_bwd_is_deterministic(cuda, b, t, din, n, kind):
    """No atomics: two calls on the same inputs give the same bits in all
    six gradients (zamba2's and falcon-mamba's training shapes, a ragged
    mixed one, many chunks, and the walk form at N 100)."""
    args, hc, dy, dh = _bwd_case(cuda, b, t, din, n, kind, 11)
    first = scan.ssm_scan_bwd(*args, hc, dy, dh)
    second = scan.ssm_scan_bwd(*args, hc, dy, dh)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,din,n,kind", [(1, 130, 256, 64, "per_head"),
                                            (2, 64, 100, 16, "general"),
                                            (1, 33, 96, scan.MAX_STATE,
                                             "mixed")])
def test_ssm_scan_checkpoints_leave_the_forward_unchanged(cuda, b, t, din, n,
                                                          kind):
    """The forward with checkpoints gives bitwise the y and final state
    of the forward without; the checkpoints are the plain forward's
    states at the chunk starts within 1e-4 (relative and absolute, as y),
    the first 0."""
    args = _scan_args(cuda, b, t, din, n, kind, 3 + t)
    y0, h0 = scan.ssm_scan_fwd(*args)
    y1, h1, hc = scan.ssm_scan_fwd(*args, with_states=True)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    _, _, want = ssm_scan_with_states_ref(*args)
    assert hc.shape == want.shape and not hc[:, 0].any()
    torch.testing.assert_close(hc, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ssm_scan_trains_through_the_kernels(cuda):
    """Inputs that require grad go through ``SSMScan``: one forward launch
    with checkpoints and one backward launch, whose gradients are
    ``ssm_scan_bwd``'s on the saved inputs; the final state's gradient
    may be unused."""
    args = [z.requires_grad_(True) for z in _scan_args(cuda, 2, 100, 96, 16,
                                                        "mixed", 4)]
    dy = torch.randn((2, 100, 96), device=cuda)
    kc.reset_launches()
    y, _ = scan.ssm_scan(*args)
    grads = torch.autograd.grad(y, args, dy)
    assert (kc.launches["ssm_scan"], kc.launches["ssm_scan_bwd"]) == (1, 1)
    with torch.no_grad():
        _, _, hc = scan.ssm_scan_fwd(*args, with_states=True)
        want = scan.ssm_scan_bwd(*args, hc, dy)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def _heads_case(device, b, t, nh, n, x_type, with_dh, seed):
    """The per-head backward's inputs on the card: (x, dt_h, a_h, Bm, Cm,
    D, h_chunks from the forward kernel, dy, dh or None)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: _on(rng.standard_normal(s).astype(np.float32),  # noqa
                       device)
    x = r(b, t, nh * 64).to(x_type)
    dt_h = torch.nn.functional.softplus(r(b, t, nh) - 1.0)
    a_h = -torch.exp(r(nh) * 0.5)
    bm, cm, d, dy = r(b, t, n), r(b, t, n), r(nh * 64), r(b, t, nh * 64)
    dt, a = heads_to_channels(dt_h, a_h, 64, n)
    _, _, hc = scan.ssm_scan_fwd(x, dt, a, bm, cm, d, with_states=True)
    return x, dt_h, a_h, bm, cm, d, hc, dy, r(b, nh * 64, n) if with_dh \
        else None


def _check_heads_bwd(got, want, tol=1e-4):
    """Each gradient within ``tol`` of its largest |.|; a bf16 dx also
    within one bf16 ulp (2^-7 |dx|): both sides round a float32 dx."""
    for name, g, w in zip(("dx", "ddt_h", "da_h", "dB", "dC", "dD"), got,
                          want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        torch.testing.assert_close(
            g.float(), w.float(),
            rtol=2**-7 if w.dtype == torch.bfloat16 else 0,
            atol=tol * float(w.float().abs().max()), msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,nh,n,x_type,with_dh", [
    (2, 130, 7, 64, torch.float32, True),    # ragged, a group and a part
    (1, 512, 80, 64, torch.bfloat16, False),  # zamba2's heads, one row
    (2, 37, 2, 16, torch.float32, True),     # reduced zamba2's states
    (1, 200, 10, 36, torch.bfloat16, True),  # N not a power of two
    (1, 1, 1, 8, torch.float32, True)])      # one step
def test_ssm_scan_heads_bwd_kernel_matches_plain(cuda, b, t, nh, n, x_type,
                                                 with_dh):
    """``ssm_scan_heads_bwd`` (one wrapper call: the end-state kernel,
    then the chunked one) against ``ssm_scan_heads_bwd_ref`` on the card,
    each gradient within 1e-4 of its largest |.| (3xTF32 products within
    about 2^-22 of float32, sums in another order: dB and dC over the
    heads, dA and dD over the chunks), a bf16 dx also within a bf16
    ulp."""
    args = _heads_case(cuda, b, t, nh, n, x_type, with_dh, t + nh + n)
    before = dict(kc.launches)
    got = scan.ssm_scan_heads_bwd(*args)
    assert kc.launches["ssm_scan_heads_bwd"] == before[
        "ssm_scan_heads_bwd"] + 1
    assert kc.launches["ssm_scan_bwd"] == before["ssm_scan_bwd"]
    _check_heads_bwd(got, ssm_scan_heads_bwd_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,nh,x_type", [(4, 512, 80, torch.bfloat16),
                                           (2, 130, 10, torch.float32)])
def test_ssm_scan_heads_bwd_is_deterministic(cuda, b, t, nh, x_type):
    """No atomics: two calls on the same inputs give the same bits in all
    six gradients (zamba2's training shape, and a ragged one with a
    final-state gradient)."""
    args = _heads_case(cuda, b, t, nh, 64, x_type, t < 512, 12)
    first = scan.ssm_scan_heads_bwd(*args)
    second = scan.ssm_scan_heads_bwd(*args)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("di,nh,n", [(256, 8, 64), (256, 2, 128),
                                     (128, 2, 18)])
def test_ssm_scan_heads_bwd_refuses_other_shapes(cuda, di, nh, n):
    """Heads of 32 or 128 channels, more than 64 states or a count not a
    multiple of 4 raise, naming the shapes it takes (the general route is
    ``ssm_scan``); nothing is launched."""
    x = torch.zeros((1, 10, di), device=cuda)
    dt_h = torch.ones((1, 10, nh), device=cuda)
    bm = torch.zeros((1, 10, n), device=cuda)
    hc = torch.zeros((1, 1, di, n), device=cuda)
    before = kc.launches["ssm_scan_heads_bwd"]
    with pytest.raises(ValueError, match="heads of 64 channels"):
        scan.ssm_scan_heads_bwd(x, dt_h, -dt_h[0, 0], bm, bm,
                                torch.zeros(di, device=cuda), hc, x)
    assert kc.launches["ssm_scan_heads_bwd"] == before


@pytest.mark.cuda
def test_ssm_scan_heads_trains_through_the_kernels(cuda):
    """Inputs that require grad go through ``SSMScanHeads``: one forward
    launch with checkpoints and one launch of the per-head backward (none
    of the per-channel one), whose gradients are ``ssm_scan_heads_bwd``'s
    on the saved inputs, dt_h's and a_h's included."""
    x, dt_h, a_h, bm, cm, d, _, dy, _ = _heads_case(cuda, 2, 100, 3, 16,
                                                     torch.float32, False, 4)
    leaves = [z.requires_grad_(True) for z in (x, dt_h, a_h, bm, cm, d)]
    kc.reset_launches()
    y, _ = scan.ssm_scan_heads(*leaves)
    grads = torch.autograd.grad(y, leaves, dy)
    assert (kc.launches["ssm_scan"], kc.launches["ssm_scan_heads_bwd"],
            kc.launches["ssm_scan_bwd"]) == (1, 1, 0)
    with torch.no_grad():
        dt, a = heads_to_channels(dt_h, a_h, 64, 16)
        _, _, hc = scan.ssm_scan_fwd(x, dt, a, bm, cm, d, with_states=True)
        want = scan.ssm_scan_heads_bwd(x, dt_h, a_h, bm, cm, d, hc, dy)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_ssm_apply_gradients_on_the_card_match_the_cpu(cuda):
    """Reduced zamba2's ``ssm_apply`` (float32, TF32 off) with a random
    linear loss: every gradient (the block's twelve weights and x) on the
    card, through the scan's forward and per-head backward kernels (one
    launch each; the per-channel backward none), within 1e-4 of its
    leaf's largest |g| of the plain path on the CPU.  On the CPU a 1e-7
    relative change of the weights moves these gradients by at most
    3.1e-6 of a leaf's largest (a gain of about 30), and float32 rounding
    on the two devices differs by a few ulps of each operation's output,
    so 1e-4 leaves a margin of three or more."""
    from repro_torch import configs as C
    from repro_torch.models import spec as sp
    from repro_torch.models import ssm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = C.get("zamba2-2.7b").reduced()
    params = sp.init_tree(torch.Generator().manual_seed(0),
                          ssm.ssm_spec(cfg), torch.float32, "cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 70, cfg.d_model), generator=gen)
    w = torch.randn((2, 70, cfg.d_model), generator=gen)
    out = {}
    for device in (cuda, torch.device("cpu")):
        p = sp.tree_map(lambda z: z.to(device).requires_grad_(True), params)
        xx = x.to(device).requires_grad_(True)
        kc.reset_launches()
        y = ssm.ssm_apply(cfg, p, xx)
        names = sorted(p)
        grads = torch.autograd.grad((y * w.to(device)).sum(),
                                    [p[k] for k in names] + [xx])
        out[device.type] = ([g.cpu() for g in grads], dict(kc.launches))
    (g_gpu, counts), (g_cpu, _) = out["cuda"], out["cpu"]
    assert (counts["ssm_scan"], counts["ssm_scan_heads_bwd"],
            counts["ssm_scan_bwd"]) == (1, 1, 0)
    for a, b in zip(g_gpu, g_cpu):
        assert bool(b.abs().max() > 0)
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def _general_a(params):
    """Mamba-1's published A (A[d, n] = -(n + 1): A_log[d, n] = log(n +
    1)) in every ``A_log`` leaf of a Mamba-1 parameter tree, in place: the
    reference's zeros make every row of A constant, and the kernels take
    their constant-row route on those."""
    for blk in params["blocks"].values():
        a_log = blk["ssm"]["A_log"]
        n = a_log.shape[-1]
        a_log.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32))
                    .to(a_log))
    return params


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "internlm2-1.8b",
                                  "falcon-mamba-7b", "granite-moe-1b-a400m"])
def test_reduced_serve_on_the_card_matches_the_cpu(cuda, arch):
    """Prefill and two decode steps of a reduced config: the kernels on
    the card against the plain versions on the CPU, logits within 2e-4
    (prefill) and 5e-4 (decode), the bounds of the CPU parity with JAX.
    falcon-mamba (Mamba-1) with its published A, so the scan takes its
    general route."""
    from repro_torch import configs as C
    from repro_torch.models import lm
    from repro_torch.models import spec as sp

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = C.get(arch).reduced()
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    if cfg.ssm_state and cfg.ssm_version == 1:   # Mamba-1 layers
        _general_a(params)
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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "internlm2-1.8b"])
def test_reduced_bf16_prefill_on_the_card_matches_the_cpu(cuda, arch):
    """A reduced config in bfloat16: prefill logits on the card (the
    wgmma flash kernel, the bf16 scan input) against the plain path on the
    CPU from the same bf16 weights, within 2^-4 of the largest |logit|.
    Each bf16 rounding (some 14 per layer and 2 at the head) may land one
    ulp apart on the two, at most 2^-7 of the element; such flips add up
    like a random walk, sqrt(30) 2^-7 = 0.043 for two layers, and the
    kernel's rounding of P adds 2^-8 of |v| per attention layer."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.models import lm
    from repro_torch.models import spec as sp

    cfg = dataclasses.replace(C.get(arch).reduced(), dtype="bfloat16")
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 70)).astype(np.int32))
    out = {}
    for device in (cuda, torch.device("cpu")):
        p = sp.tree_map(lambda x: x.to(device), params)
        with torch.no_grad():
            last, _ = lm.prefill(cfg, p, {"tokens": tokens.to(device)})
        out[device.type] = last.float().cpu()
    scale = float(out["cpu"].abs().max())
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=0,
                               atol=2**-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
def test_reduced_train_gradients_on_the_card_match_the_cpu(cuda, remat):
    """Reduced internlm2 (float32, TF32 off): the loss within 1e-5
    relative and every gradient within 1e-4 of its leaf's largest |g| of
    the plain path on the CPU (f32 sums in another order; the f32 flash
    forward in 3xTF32, within 2e-5 of its output; the backward kernels in
    3xTF32), through the flash forward and backward kernels, one launch
    each per layer."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.data import pipeline as dp
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import lm
    from repro_torch.models import spec as sp

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(C.get("internlm2-1.8b").reduced(),
                              remat_policy=remat)
    params = lm.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = dp.batch_at(cfg, ShapeConfig("t", 64, 2, "train"), 0, 0)
    out = {}
    for device in (cuda, torch.device("cpu")):
        p = sp.tree_map(lambda x: x.to(device).requires_grad_(True), params)
        kc.reset_launches()
        loss, _ = lm.loss_fn(cfg, p, dp.to_device(batch, device),
                             remat=True)
        grads = torch.autograd.grad(loss, sp.tree_leaves(p))
        out[device.type] = (float(loss.detach()), [g.cpu() for g in grads],
                            dict(kc.launches))
    (l_gpu, g_gpu, counts), (l_cpu, g_cpu, _) = out["cuda"], out["cpu"]
    fwd = cfg.n_layers * (2 if remat == "full" else 1)
    assert (counts["flash_attention"], counts["flash_attention_bwd"]) == (
        fwd, cfg.n_layers)
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for a, b in zip(g_gpu, g_cpu):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(2, 130), (1, 77)])
def test_ssm_scan_general_a_at_falcon_width_matches_plain(cuda, b, t):
    """The general-A routes at a reduced falcon-mamba shape (di 256, N 16,
    T past a chunk and ragged), A Mamba-1's published -(n + 1) in every
    row and x bf16, as the model gives them: ``ssm_scan`` within 1e-4
    (relative and absolute) of ``ssm_scan_ref``, and ``ssm_scan_bwd`` from
    the kernel's own checkpoints within 1e-4 of each gradient's largest
    of ``ssm_scan_bwd_ref`` (the bf16 dx also within one bf16 ulp of the
    element: both sides round an f32 dx, and a rounding may flip), two
    calls the same bits."""
    din, n = 256, 16
    args = _scan_args(cuda, b, t, din, n, "general", 7 + t)
    args[0] = args[0].to(torch.bfloat16)
    args[2] = -torch.arange(1, n + 1, dtype=torch.float32,
                            device=cuda).expand(din, n).contiguous()
    kc.reset_launches()
    y, h, hc = scan.ssm_scan_fwd(*args, with_states=True)
    want_y, want_h, want_hc = ssm_scan_with_states_ref(*args)
    for got, want in ((y, want_y), (h, want_h), (hc, want_hc)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    rng = np.random.default_rng(t)
    dy = _on(rng.standard_normal((b, t, din)).astype(np.float32), cuda)
    got = scan.ssm_scan_bwd(*args, hc, dy)
    assert (kc.launches["ssm_scan"], kc.launches["ssm_scan_bwd"]) == (1, 1)
    want = ssm_scan_bwd_ref(*args, hc, dy)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        torch.testing.assert_close(
            g.float(), w.float(), rtol=2**-8 if name == "dx" else 0,
            atol=1e-4 * float(w.float().abs().max()), msg=name)
    for x, z in zip(got, scan.ssm_scan_bwd(*args, hc, dy)):
        assert torch.equal(x, z)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
def test_reduced_falcon_mamba_trains_on_the_card_like_the_cpu(cuda, remat):
    """Reduced falcon-mamba (Mamba-1, float32, TF32 off, its published A):
    the loss of ``lm.loss_fn`` within 1e-5 relative and every gradient
    within 1e-4 of its leaf's largest |g| of the plain path on the CPU,
    through the general-A forward and the per-channel backward kernels:
    ``ssm_scan`` once a layer (twice under remat "full"),
    ``ssm_scan_bwd`` once a layer, ``ssm_scan_heads_bwd`` never.  On the
    CPU a 1e-7 relative change of the weights moves the reduced model's
    gradients by about 1e-6 of a leaf's largest, so 1e-4 leaves a wide
    margin for float32 sums in another order."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline as dp
    from repro_torch.models import lm
    from repro_torch.models import spec as sp

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(C.get("falcon-mamba-7b").reduced(),
                              remat_policy=remat)
    params = _general_a(lm.init(torch.Generator().manual_seed(0), cfg,
                                device="cpu"))
    batch = dp.batch_at(cfg, ShapeConfig("t", 100, 2, "train"), 0, 0)
    out = {}
    for device in (cuda, torch.device("cpu")):
        p = sp.tree_map(lambda x: x.to(device).requires_grad_(True), params)
        kc.reset_launches()
        loss, _ = lm.loss_fn(cfg, p, dp.to_device(batch, device),
                             remat=True)
        grads = torch.autograd.grad(loss, sp.tree_leaves(p))
        out[device.type] = (float(loss.detach()), [g.cpu() for g in grads],
                            dict(kc.launches))
    (l_gpu, g_gpu, counts), (l_cpu, g_cpu, _) = out["cuda"], out["cpu"]
    fwd = cfg.n_layers * (2 if remat == "full" else 1)
    assert (counts["ssm_scan"], counts["ssm_scan_bwd"],
            counts["ssm_scan_heads_bwd"]) == (fwd, cfg.n_layers, 0)
    assert abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu)
    for a, b in zip(g_gpu, g_cpu):
        assert bool(b.abs().max() > 0)
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_on_the_card_is_deterministic_and_routes_as_the_cpu(
        cuda, dtype):
    """One granite-moe MoE layer at full width (d_model 1024, 32 experts
    top-8, d_ff 512) on 2 x 128 tokens at capacity factor 1, so lanes
    drop: the integer routing (expert choices, slots, counts) on the card
    equals the CPU's bitwise; two calls on the card give the same bits in
    the output and in every gradient (x and the four weight leaves: no
    atomics in the dispatch or the combine); in float32 the output is
    within 1e-4 of its largest of the CPU's."""
    import dataclasses

    from repro_torch import configs as C
    from repro_torch.models import moe
    from repro_torch.models import spec as sp

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(C.get("granite-moe-1b-a400m"),
                              capacity_factor=1.0)
    gen = torch.Generator().manual_seed(0)
    params = sp.init_tree(gen, moe.moe_spec(cfg), dtype, "cpu")
    x = torch.randn((2, 128, cfg.d_model), generator=gen).to(dtype)
    dy = torch.randn((2, 128, cfg.d_model), generator=gen).to(dtype)

    def run(device):
        w = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
        xd = x.to(device).requires_grad_(True)
        routing = {}
        y, m = moe.moe_apply(cfg, w, xd, routing=routing)
        grads = torch.autograd.grad((y, m["aux_loss"]), [xd, *w.values()],
                                    (dy.to(device), torch.ones((),
                                                               device=device)))
        ints = [routing[k].cpu() for k in ("expert_idx", "slot", "counts")]
        return y.detach().cpu(), [g.cpu() for g in grads], ints, m

    y1, g1, r1, m1 = run(cuda)
    y2, g2, r2, _ = run(cuda)
    yc, _, rc, _ = run(torch.device("cpu"))
    assert float(m1["drop_fraction"]) > 0
    for a, b in zip(r1, rc):
        assert torch.equal(a, b)
    assert torch.equal(y1, y2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    if dtype == torch.float32:
        scale = float(yc.abs().max())
        assert float((y1 - yc).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_moe_top_k_ties_on_the_card_go_to_the_lower_expert(cuda):
    """``moe.route`` on the card orders equal probabilities as
    ``jax.lax.top_k`` does, the lower expert first: a zero router ties
    all 32 experts (top-8 is experts 0..7 on every token); a router that
    passes x's first 32 features through unchanged (logits exactly x,
    on any device) with feature 5 a copy of feature 4 ties experts 4 and
    5, and wherever both are chosen 4 comes just before 5."""
    from repro_torch.models import moe

    x = torch.randn((4096, 1024), generator=torch.Generator().manual_seed(0))
    x[:, 5] = x[:, 4]
    idx = moe.route(x.to(cuda), torch.zeros((1024, 32), device=cuda),
                    8)[2].cpu()
    assert torch.equal(idx, torch.arange(8).expand(4096, 8))
    idx = moe.route(x.to(cuda), torch.eye(1024, 32, device=cuda), 8)[2].cpu()
    both = (idx == 4).any(-1) & (idx == 5).any(-1)
    assert int(both.sum()) > 100
    pos4 = (idx[both] == 4).int().argmax(-1)
    pos5 = (idx[both] == 5).int().argmax(-1)
    assert torch.equal(pos5, pos4 + 1)


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


@pytest.mark.cuda
@pytest.mark.parametrize("gen_device", ["cuda", "cpu"])
def test_sliced_init_holds_one_draw_beside_the_leaf(cuda, gen_device):
    """A stacked bf16 leaf of 2^27 elements (256 MiB; 512 MiB in float32)
    drawn straight onto the card: the allocator's peak stays within the
    leaf's bytes plus one float32 draw (``DRAW_ELEMS``, 64 MiB: a block of
    4096 rows, half of one [8192, 4096] slice), from a generator on the
    card or on the CPU (drawn there, copied a block at a time), and both
    generators fill every slice differently."""
    from repro_torch.models import spec as sp

    tree = {"w": sp.stack_specs({"w": sp.ParamSpec((8192, 4096),
                                                   (None, None))}, 4)["w"]}
    leaf = 4 * 8192 * 4096 * 2
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=gen_device).manual_seed(0)
    params = sp.init_tree(gen, tree, torch.bfloat16, cuda)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    w = params["w"]
    assert w.device.type == "cuda" and w.dtype == torch.bfloat16
    assert peak <= leaf + 4 * sp.DRAW_ELEMS, (peak, leaf)
    assert peak < leaf + 4 * 8192 * 4096      # below one float32 slice more
    assert abs(float(w[0].float().std()) * 90.50967 - 1) < 0.01
    assert not torch.equal(w[0], w[1])


@pytest.mark.cuda
def test_shard_superstep_at_world_1_on_nccl_matches_the_local_run(
        cuda, tmp_path):
    """The shard form at world 1 on NCCL (every chip on the one rank, the
    exchange one ``all_to_all_single``), in a spawned process: spikes,
    voltages, every integer stat, ring and merge queue equal the local
    run on the card, and the path's kernels launch.  Last in the file:
    after the spawn, torch.profiler in this process recorded no device
    activity on the card's machine, and the tests above read it."""
    import torch_dist

    if not torch.distributed.is_nccl_available():
        pytest.fail("this PyTorch has no NCCL")
    (out,) = torch_dist.spawn(torch_dist.card_shard_worker, 1, tmp_path,
                              backend="nccl")
    assert all(out["equal"].values()), out["equal"]
    assert out["sent"] > 0
    for k in ("fused_inject", "fused_drain", "lif_step"):
        assert out["launches"][k] > 0, out["launches"]
