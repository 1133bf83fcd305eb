"""The premises of the card's fused inject kernels, on the CPU.

``csrc/fused_inject.cu`` runs one CTA per (chip, substep) for both
kernels.  These tests hold the arithmetic that design relies on against
the plain versions (which ``tests/test_torch_kernels.py`` and
``tests/test_torch_kernels_snn.py`` hold against the JAX package):

* ``fused_inject``'s write rule, emulated in numpy CTA by CTA, tile by
  tile and warp by warp: with no lane whose negative bucket wraps into
  range, members own distinct cells, so each word is stored straight
  into the slab and the cells past min(count, C) get the sentinel; when
  a block vote finds such a lane, or a row spans several tiles, each
  cell goes to the latest lane that lands on it.
* ``fused_lif_inject``: the LIF recurrence of substep k, recomputed from
  the block's initial state, gives the carried one bitwise, and the
  inject of the dense fired rows (one lane per neuron) equals the inject
  of the compacted events.
* The wrappers: the arguments that go to the launch as they are, and the
  outputs as views of one buffer.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import events as ev
from repro_torch.core import routing as rt
from repro_torch.kernels.fused_inject import ops as fi
from repro_torch.kernels.fused_inject.ref import (fused_inject_ref,
                                                 fused_lif_inject_ref)
from repro_torch.kernels.lif_step.ref import lif_step_ref
from repro_torch.snn import neuron as nr

N_CHIPS = 5


def _i32(x):
    """int32 wrap-around of an int64 array."""
    return np.asarray(x, np.int64).astype(np.int32)


def _cta_inject_np(valid, addr, time, table, *, chip, k, b, bpc, cap, full,
                   window, now, threads):
    """One CTA of the kernel on one row of E lanes: returns the slab rows
    ``[nb, cap]``, counts ``[nb]``, sent, overflow, wrap_expired, traffic
    ``[n_chips]`` and whether the cells were resolved in shared memory."""
    lut_chip, lut_addr, lut_delay, lut_valid = (x[chip, :, 0] for x in table)
    n = lut_chip.shape[0]
    nb = N_CHIPS * bpc
    e_len = valid.shape[0]
    lanes = -(-max(e_len, 1) // threads) * threads
    pad = lanes - e_len
    valid = np.concatenate([valid, np.zeros(pad, bool)])
    addr = np.concatenate([addr, np.zeros(pad, np.int32)])
    time = np.concatenate([time, np.zeros(pad, np.int32)])
    # route and admit (the kernel's route())
    a = np.where(valid, addr, 0)
    a = np.clip(np.where(a < 0, a + n, a), 0, n - 1)
    ok = valid & lut_valid[a]
    dest_chip = np.where(ok, lut_chip[a], 0).astype(np.int64)
    dest_addr = np.where(ok, lut_addr[a], -1).astype(np.int64)
    deadline = _i32(time.astype(np.int64) + lut_delay[a]).astype(np.int64)
    diff = _i32(deadline - now).astype(np.int64)
    in_window = (diff > b - 1 - k) & (diff < 128)
    v = ok & in_window
    bid = _i32(dest_chip * bpc).astype(np.int64)
    if full:
        bid = _i32(bid + (deadline // max(window, 1)) % bpc).astype(np.int64)
    word = _i32(((dest_addr & 0x3FFF) << 8) | (deadline & 0xFF))
    member = v & (bid >= 0) & (bid < nb)
    key = np.clip(bid, 0, nb - 1)

    staged = e_len > threads
    owner = np.full((nb, cap), -1, np.int64)
    cells = np.full((nb, cap), -1, np.int32)
    written = np.zeros((nb, cap), np.int64)
    running = np.zeros(nb, np.int64)
    overflow = 0
    lower = np.tri(32, k=-1, dtype=bool)         # lane j < lane i
    for base in range(0, lanes, threads):
        t = slice(base, base + threads)
        wk, wm = key[t].reshape(-1, 32), member[t].reshape(-1, 32)
        hist = np.stack([((wk == j) & wm).sum(1) for j in range(nb)], 1)
        in_warp = ((wk[:, :, None] == wk[:, None, :]) & wm[:, None, :]
                   & lower).sum(2)
        first = running + np.cumsum(hist, 0) - hist    # [warps, nb]
        running = running + hist.sum(0)
        slot = (np.take_along_axis(first, wk, 1) + in_warp).reshape(-1)
        lane_v, lane_bid = v[t], bid[t]
        keep = lane_v & (slot < cap)
        overflow += int((lane_v & (slot >= cap)).sum())
        if (lane_v & (lane_bid < 0) & (lane_bid >= -nb)).any():
            staged = True
        e = np.arange(base, base + threads)
        if not staged:
            for i in np.nonzero(keep & member[t])[0]:
                cells[lane_bid[i], slot[i]] = word[t][i]
                written[lane_bid[i], slot[i]] += 1
            continue
        cell_b = np.where(lane_bid < 0, lane_bid + nb, lane_bid)
        lands = keep & (cell_b >= 0) & (cell_b < nb)
        for i in np.nonzero(lands)[0]:           # atomicMax of the lane
            owner[cell_b[i], slot[i]] = max(owner[cell_b[i], slot[i]], e[i])
        for i in np.nonzero(lands)[0]:           # after the barrier
            if owner[cell_b[i], slot[i]] == e[i]:
                cells[cell_b[i], slot[i]] = word[t][i]
    if staged:
        cells = np.where(owner >= 0, cells, -1)
    else:
        # members own distinct cells, exactly [0, min(count, C))
        filled = np.minimum(running, cap)[:, None] > np.arange(cap)
        assert (written == filled).all()
        cells = np.where(filled, cells, -1)
    to = v & (dest_chip >= 0) & (dest_chip < N_CHIPS)
    traffic = np.bincount(dest_chip[to], minlength=N_CHIPS)[:N_CHIPS]
    return (cells, running, int(ok.sum()), overflow,
            int((ok & ~in_window).sum()), traffic, staged)


def _block(b, e, kind, seed):
    rng = np.random.default_rng(seed)
    n = 40
    t0 = np.array([0, 100, 250, 254, 7], np.int32)
    addr = rng.integers(-3, n + 3, (b, N_CHIPS, e)).astype(np.int32)
    time = (t0[None, :, None] + rng.integers(0, b + 1, (b, N_CHIPS, e))
            ).astype(np.int32)
    valid = rng.random((b, N_CHIPS, e)) < 0.7
    valid[0, 0] = False                          # an all-invalid row
    lo = {"in_range": 0, "negative": -2}.get(kind, -1)
    dest = rng.integers(lo, N_CHIPS if kind != "minus_one" else 0,
                        (N_CHIPS, n, 1)).astype(np.int32)
    dest[1, :, 0] = np.where(dest[1, :, 0] < 0, dest[1, :, 0], 1)
    table = (dest, rng.integers(0, n, (N_CHIPS, n, 1)).astype(np.int32),
             rng.choice([0, 3, 9, 12, 130], (N_CHIPS, n, 1)).astype(np.int32),
             rng.random((N_CHIPS, n, 1)) < 0.9)
    return (addr, time, valid), table, t0


@pytest.mark.parametrize("kind", ["in_range", "negative", "minus_one"])
@pytest.mark.parametrize("mode", ["simplified", "full"])
@pytest.mark.parametrize("e", [70, 512, 1500])
def test_fused_inject_block_arithmetic_equals_plain(e, mode, kind):
    """The kernel's per-CTA rule gives the plain version's every output:
    rows of one tile (70, and 512 as at the feedforward cell) and of
    three (1500); tables in range (every CTA stores words straight into the
    slab), with dest_chip down to -2, and with dest_chip -1 on every entry
    (every admitted lane wraps, and lanes collide on cells); an
    all-invalid row and buckets over capacity (chip 1's lanes all go to
    one chip)."""
    b, bpc, cap, window = 2, 2, 4, 4
    (addr, time, valid), table, t0 = _block(b, e, kind, e + len(mode))
    full = mode == "full"
    threads = fi.launch_plan(e, N_CHIPS, N_CHIPS * bpc, cap)[0]
    want = fused_inject_ref(
        ev.EventBuffer(*map(torch.as_tensor, (addr, time, valid))),
        rt.RoutingTable(*map(torch.as_tensor, table)), torch.as_tensor(t0),
        n_chips=N_CHIPS, buckets_per_chip=bpc, capacity=cap, mode=mode,
        time_window=window)
    paths = set()
    for k in range(b):
        for chip in range(N_CHIPS):
            got = _cta_inject_np(
                valid[k, chip], addr[k, chip], time[k, chip], table,
                chip=chip, k=k, b=b, bpc=bpc, cap=cap, full=full,
                window=window, now=int(t0[chip]) + k, threads=threads)
            np.testing.assert_array_equal(got[0], want.slab[chip, :, k])
            np.testing.assert_array_equal(got[1], want.counts[k, chip])
            for g, w in zip(got[2:5], (want.sent, want.overflow,
                                       want.wrap_expired)):
                assert g == int(w[k, chip])
            np.testing.assert_array_equal(got[5], want.traffic[k, chip])
            paths.add(got[6])
    # The all-invalid row never wraps; every other row of a table with
    # negative entries has a lane that does.
    assert paths == ({True} if e > threads else
                     {False} if kind == "in_range" else {False, True})
    assert int(want.sent[0, 0]) == 0
    if kind != "minus_one":              # no lane is a member there
        assert int(want.overflow.sum()) > 0


def _lif_block(b, seed, n=40):
    rng = np.random.default_rng(seed)
    v = rng.normal(0.2, 0.8, (N_CHIPS, n)).astype(np.float32)
    refrac = rng.choice([0, 0, 0, 2], (N_CHIPS, n)).astype(np.int32)
    cur = rng.normal(0.6, 0.9, (b, N_CHIPS, n)).astype(np.float32)
    params = nr.LIFParams(
        *(torch.as_tensor(x) for x in (
            rng.uniform(1.5, 30.0, (N_CHIPS, n)).astype(np.float32),
            rng.choice([0.5, 1.0], (N_CHIPS, n)).astype(np.float32),
            rng.choice([0.0, -0.25], (N_CHIPS, n)).astype(np.float32),
            np.zeros((N_CHIPS, n), np.float32),
            rng.integers(1, 4, (N_CHIPS, n)).astype(np.int32))))
    table = rt.RoutingTable(
        torch.as_tensor(rng.integers(-1, N_CHIPS, (N_CHIPS, n, 1)),
                        dtype=torch.int32),
        torch.as_tensor(rng.integers(0, n, (N_CHIPS, n, 1)),
                        dtype=torch.int32),
        torch.as_tensor(rng.integers(b, 20, (N_CHIPS, n, 1)),
                        dtype=torch.int32),
        torch.as_tensor(rng.random((N_CHIPS, n, 1)) < 0.9))
    t0 = torch.as_tensor(np.array([0, 100, 250, 254, 7], np.int32))
    return torch.as_tensor(v), torch.as_tensor(refrac), \
        torch.as_tensor(cur), params, table, t0


@pytest.mark.parametrize("mode", ["simplified", "full"])
@pytest.mark.parametrize("b", [1, 8])
def test_lif_substeps_recomputed_per_substep_equal_the_carried_ones(b, mode):
    """CTA (chip, k) reruns the plain LIF step k + 1 times from the
    block's initial state: that gives ``fused_lif_inject_ref``'s
    ``spikes[k]`` and ``voltage[k]`` (and after B - 1 its final state)
    bitwise; and the inject of the dense fired rows, neuron e as lane e,
    with the cut rank < event_capacity, equals the inject of the
    compacted events."""
    v0, r0, cur, params, table, t0 = _lif_block(b, b + len(mode))
    kw = dict(event_capacity=6, n_chips=N_CHIPS, buckets_per_chip=2,
              capacity=4, mode=mode, time_window=4)
    want = fused_lif_inject_ref(v0, r0, cur, params, table, t0, **kw)
    fired = []
    for k in range(b):
        v, r = v0, r0
        for j in range(k + 1):
            v, r, spk = lif_step_ref(v, r, cur[j], *params)
        assert torch.equal(spk, want.spikes[k]) and torch.equal(
            v, want.voltage[k])
        rank = torch.cumsum(spk, -1) - spk
        fired.append((spk > 0.5) & (rank < kw["event_capacity"]))
    assert torch.equal(v, want.v) and torch.equal(r, want.refrac)
    fired = torch.stack(fired)
    assert bool((want.spikes.sum(-1) > kw["event_capacity"]).any())
    lanes = torch.arange(fired.shape[-1], dtype=torch.int32).expand(
        fired.shape).contiguous()
    dense = ev.EventBuffer(
        lanes, (t0 + torch.arange(b, dtype=torch.int32)[:, None])[..., None]
        .expand(fired.shape).contiguous(), fired)
    got = fused_inject_ref(dense, table, t0, **{
        x: y for x, y in kw.items() if x != "event_capacity"})
    for g, w in zip(got, want.inject):
        assert torch.equal(g, w)


def test_fused_inject_takes_only_ready_arguments_as_they_are():
    """Events, table and clock go to the launch as they are only when each
    is a contiguous tensor of the kernel's type and shape on the device."""
    (addr, time, valid), table, t0 = _block(2, 30, "in_range", 0)
    args = [torch.as_tensor(x) for x in (addr, time, valid, *table, t0)]
    dtypes = (torch.int32,) * 2 + (torch.bool,) + fi._LUT_DTYPES \
        + (torch.int32,)
    shapes = ((2, N_CHIPS, 30),) * 3 + ((N_CHIPS, 40, 1),) * 4 \
        + ((N_CHIPS,),)
    dev = torch.device("cpu")
    assert fi._ready(args, dtypes, shapes, dev)
    for i, bad in ((0, args[0].long()), (2, args[2].to(torch.uint8)),
                   (3, args[3][0]), (1, args[1].transpose(0, 1)
                                     .contiguous().transpose(0, 1)),
                   (7, 0)):
        assert not fi._ready(args[:i] + [bad] + args[i + 1:], dtypes, shapes,
                             dev)


def test_outputs_are_views_of_one_buffer_slab_first():
    """One allocation per call: every output a contiguous view of its
    shape, the slab at the buffer's start, the others after it, the last
    ones (``fused_lif_inject``'s membrane, spikes and voltage) float32."""
    inject = fi._inject_shapes(8, 46, 92, 32)
    shapes = inject + ((46, 512), (8, 46, 512))
    out = fi._outputs(torch.device("cpu"), shapes, n_float=2)
    base = out[0].untyped_storage().data_ptr()
    offset = 0
    for i, (x, sh) in enumerate(zip(out, shapes)):
        assert x.shape == sh and x.is_contiguous()
        assert x.dtype == (torch.int32 if i < len(inject) else torch.float32)
        assert x.untyped_storage().data_ptr() == base
        assert x.data_ptr() == base + 4 * offset
        offset += x.numel()
    assert out[0].data_ptr() == base


def test_launch_plans_are_cached():
    fi.launch_plan.cache_clear()
    fi.launch_plan(512, 46, 92, 32)
    fi.launch_plan(512, 46, 92, 32)
    assert fi.launch_plan.cache_info().hits == 1
