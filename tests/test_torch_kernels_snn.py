"""Port parity, the SNN kernels of the learning slice: the plain PyTorch
versions of ``lif_step``, ``merge_sort_words``, ``merge_sort`` and
``fused_lif_inject`` (and ``fused_inject`` and ``fused_lif_inject`` with a
reach row, ``lost`` included), and the merge buffer with ``use_pallas=True``,
against the JAX package's Pallas kernels in interpret mode (and its
``ref.py`` oracles), on the CPU.

On the CPU each port wrapper runs its plain version; the CUDA kernels run
only on a card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
Integer outputs are held bitwise.  A LIF voltage is held bitwise where
PyTorch's and XLA's ``exp(-1 / tau)`` agree, and within 1e-6 where the
two ``exp`` implementations differ in the last bit (random ``tau``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import events as jev  # noqa: E402
from repro.core import merge as jmg  # noqa: E402
from repro.core import routing as jrt  # noqa: E402
from repro.kernels.fused_inject import ops as jfi  # noqa: E402
from repro.kernels.lif_step import ops as jlif  # noqa: E402
from repro.kernels.merge_sort import ops as jms  # noqa: E402
from repro.kernels.merge_sort.ref import merge_sort_ref as jms_ref  # noqa: E402
from repro.snn import neuron as jnr  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import merge as mg  # noqa: E402
from repro_torch.core import routing as rt  # noqa: E402
from repro_torch.kernels import common as kc  # noqa: E402
from repro_torch.kernels.fused_inject import ops as fi  # noqa: E402
from repro_torch.kernels.lif_step import ops as lif  # noqa: E402
from repro_torch.kernels.merge_sort import ops as ms  # noqa: E402
from repro_torch.snn import neuron as nr  # noqa: E402

N_CHIPS = 3


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def same(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=msg)


# ---------------------------------------------------------------------------
# lif_step
# ---------------------------------------------------------------------------

def _lif_inputs(shape, seed, tau="random"):
    """Neuron arrays with refractory lanes, lanes that land exactly on the
    threshold (v = v_rest = 0, current = v_th: no spike, the threshold is
    strict) and lanes just above it."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0.3, 0.8, shape).astype(np.float32)
    refrac = rng.integers(-1, 4, shape).astype(np.int32)
    cur = rng.normal(0.4, 0.6, shape).astype(np.float32)
    v_th = rng.choice([0.5, 1.0, 1.25], shape).astype(np.float32)
    v_rest = np.zeros(shape, np.float32)
    at = rng.random(shape) < 0.2
    v[at], refrac[at], cur[at] = 0.0, 0, v_th[at]
    above = ~at & (rng.random(shape) < 0.1)
    v[above], refrac[above] = 0.0, 0
    cur[above] = np.nextafter(v_th[above], np.float32(2))
    if tau == "random":
        tau_m = rng.uniform(1.5, 30.0, shape).astype(np.float32)
    else:
        tau_m = np.full(shape, tau, np.float32)
    v_reset = rng.choice([0.0, -0.25], shape).astype(np.float32)
    refrac_p = rng.integers(1, 4, shape).astype(np.int32)
    return (v, refrac, cur, tau_m, v_th, v_reset, v_rest, refrac_p), at, above


@pytest.mark.parametrize("shape,tau", [((4, 32), "random"), ((2, 8), 10.0),
                                       ((3, 17), "random"), ((1000,), 10.0)])
def test_lif_step_plain_matches_pallas_interpret(shape, tau):
    args, at, above = _lif_inputs(shape, sum(shape), tau)
    wv, wr, ws = jlif.lif_step(*map(jnp.asarray, args), interpret=True)
    gv, gr, gs = lif.lif_step(*map(T, args))
    same(wr, gr, "refrac")
    same(ws, gs, "spikes")
    assert gs.dtype == torch.float32 and gr.dtype == torch.int32
    # exactly at threshold never fires; one ulp above fires
    assert not gs.numpy()[at].any() and gs.numpy()[above].all()
    # v: bitwise where the two exp(-1/tau) agree, else within 1e-6
    jdecay = np.asarray(jnp.exp(-1.0 / jnp.asarray(args[3])))
    tdecay = torch.exp(-1.0 / T(args[3])).numpy()
    agree = jdecay == tdecay
    same(np.asarray(wv)[agree], gv[torch.as_tensor(agree)], "v")
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0, atol=1e-6)
    if tau == 10.0:
        assert agree.all()


def test_neuron_lif_step_runs_the_kernel_wrapper_and_matches_jax():
    """``snn.neuron.lif_step`` (the autograd Function around the wrapper)
    equals the reference's ``neuron.lif_step`` on a [n_chips, N] batch."""
    args, _, _ = _lif_inputs((N_CHIPS, 16), 7, tau=10.0)
    v, refrac, cur, tau_m, v_th, v_reset, v_rest, refrac_p = args
    jstate, jspk = jnr.lif_step(
        jnr.LIFState(jnp.asarray(v), jnp.asarray(refrac)), jnp.asarray(cur),
        jnr.LIFParams(*map(jnp.asarray, (tau_m, v_th, v_reset, v_rest,
                                         refrac_p))))
    state, spk = nr.lif_step(nr.LIFState(T(v), T(refrac)), T(cur),
                             nr.LIFParams(*map(T, (tau_m, v_th, v_reset,
                                                   v_rest, refrac_p))))
    same(jstate.v, state.v, "v")
    same(jstate.refrac, state.refrac, "refrac")
    same(jspk, spk, "spikes")


def test_lif_step_fast_path_takes_only_ready_arguments():
    """Arguments go to the launch as they are only when every one is a
    tensor of ``v``'s shape, type and device, contiguous."""
    args = [T(x) for x in _lif_inputs((3, 8), 0)[0]]
    v = args[0]
    assert lif._ready(args, v.device, v.shape)
    for i, bad in ((3, args[3][0]), (1, args[1].long()), (0, v.double()),
                   (2, args[2].t().contiguous().t()), (5, 0.0)):
        assert not lif._ready(args[:i] + [bad] + args[i + 1:], v.device,
                              v.shape)


# ---------------------------------------------------------------------------
# merge_sort_words / merge_sort
# ---------------------------------------------------------------------------

def _words(rng, shape, now, max_ahead, density):
    addr = rng.integers(0, 1 << 14, shape)
    dead = np.asarray(now)[..., None] + rng.integers(-max_ahead,
                                                     max_ahead + 1, shape)
    valid = rng.random(shape) < density
    return np.where(valid, ((addr & 0x3FFF) << 8) | (dead & 0xFF),
                    -1).astype(np.int32)


@pytest.mark.parametrize("l,max_ahead,density,now",
                         [(1, 4, 1.0, 0), (7, 3, 0.5, 10), (128, 8, 0.6, 250),
                          (136, 100, 0.3, 200), (500, 2, 0.9, 255),
                          (1024, 64, 0.0, 1000003)])
def test_merge_sort_words_plain_matches_pallas_interpret(l, max_ahead,
                                                         density, now):
    """The parametrisation of the reference's own kernel test: L below
    128, not a power of two, wrapping deadlines, heavy ties, sentinels."""
    rng = np.random.default_rng(l + max_ahead)
    words = _words(rng, (l,), now, max_ahead, density)
    want = jms.merge_sort_words(jnp.asarray(words), jnp.int32(now),
                                interpret=True)
    same(want, ms.merge_sort_words(T(words), now))


def test_merge_sort_words_plain_batches_rows_with_their_clocks():
    rng = np.random.default_rng(3)
    now = np.array([0, 250, 255, 123], np.int32)
    words = _words(rng, (4, 70), now, 30, 0.6)
    want = jax.vmap(lambda w, t: jms.merge_sort_words(w, t, interpret=True))(
        jnp.asarray(words), jnp.asarray(now))
    same(want, ms.merge_sort_words(T(words), T(now)))


def _soa(rng, l, lo, hi, density):
    return (rng.integers(0, 1 << 14, l).astype(np.int32),
            rng.integers(lo, hi, l, dtype=np.int64).astype(np.int32),
            rng.random(l) < density)


@pytest.mark.parametrize("l,lo,hi,density", [
    (128, -50, 50, 0.7),                        # negative deadlines
    (256, 2**30 - 8, 2**30 + 8, 0.6),           # around the invalid key
    (128, -2**31, 2**31 - 1, 0.5),              # the whole int32 range
    (512, 0, 6, 0.3)])                          # heavy ties
def test_merge_sort_plain_matches_pallas_interpret(l, lo, hi, density):
    """Power-of-two rows: the Pallas wrapper pads nothing, so its kernel
    sorts the same lanes as the reference."""
    lanes = _soa(np.random.default_rng(l + int(density * 10)), l, lo,
                 hi, density)
    want = jms.merge_sort(*map(jnp.asarray, lanes), interpret=True)
    got = ms.merge_sort(*map(T, lanes))
    for w, g, name in zip(want, got, ("addr", "deadline", "valid")):
        same(w, g, name)


@pytest.mark.parametrize("l", [1, 70, 300])
def test_merge_sort_plain_matches_reference_on_padded_rows(l):
    """Rows the Pallas wrapper pads: with every valid deadline below 2^30
    the Pallas kernel and the reference agree and the port equals both;
    with valid deadlines above 2^30 the port equals the reference (the
    Pallas wrapper parks its padding lanes, key 2^30, ahead of them and
    cuts those lanes off)."""
    rng = np.random.default_rng(l)
    low = _soa(rng, l, -100, 2**30, 0.6)
    want = jms.merge_sort(*map(jnp.asarray, low), interpret=True)
    for w, g in zip(want, ms.merge_sort(*map(T, low))):
        same(w, g)
    high = _soa(rng, l, 2**30 - 4, 2**31 - 1, 0.6)
    want = jms_ref(*map(jnp.asarray, high))
    for w, g in zip(want, ms.merge_sort(*map(T, high))):
        same(w, g)


def test_merge_sort_plain_batches_rows():
    rng = np.random.default_rng(9)
    lanes = [np.stack(x) for x in zip(*(_soa(rng, 70, -9, 9, 0.5)
                                        for _ in range(4)))]
    want = jax.vmap(jms_ref)(*map(jnp.asarray, lanes))
    for w, g in zip(want, ms.merge_sort(*map(T, lanes))):
        same(w, g)


# ---------------------------------------------------------------------------
# the merge buffer with use_pallas=True (the reference interprets its
# kernel on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate,depth", [(3, 8), (5, 16)])
def test_merge_step_words_pallas_matches_jax(rate, depth):
    rng = np.random.default_rng(rate)
    now = np.array([5, 250, 100], np.int32)
    jbuf = jmg.MergeBuffer(words=jnp.full((N_CHIPS, depth), -1, jnp.int32))
    buf = mg.merge_init(depth, batch_shape=(N_CHIPS,))
    step = jax.vmap(lambda b, w, t: jmg.merge_step_words(
        b, w, now=t, rate=rate, use_pallas=True))
    for cycle in range(4):
        words = _words(rng, (N_CHIPS, 12), now + cycle, 20, 0.8)
        jbuf, jout, jdrop = step(jbuf, jnp.asarray(words),
                                 jnp.asarray(now + cycle))
        buf, out, drop = mg.merge_step_words(buf, T(words), now=T(now + cycle),
                                             rate=rate, use_pallas=True)
        same(jbuf.words, buf.words, "queue")
        same(jout, out, "out")
        same(jdrop, drop, "dropped")


@pytest.mark.parametrize("b", [1, 4])
def test_merge_drain_words_pallas_matches_jax(b):
    rng = np.random.default_rng(b)
    now0 = np.array([0, 254, 77], np.int32)
    queue = _words(rng, (N_CHIPS, 8), now0, 5, 0.9)
    words = np.stack([_words(rng, (N_CHIPS, 20), now0 + k, 30, 0.7)
                      for k in range(b)])
    def drain(q, w, t):
        return jmg.merge_drain_words(jmg.MergeBuffer(words=q), w, now0=t,
                                     rate=4, use_pallas=True)
    jbuf, jout, jdrop = jax.vmap(drain, in_axes=(0, 1, 0), out_axes=(0, 1, 1))(
        jnp.asarray(queue), jnp.asarray(words), jnp.asarray(now0))
    buf, out, drop = mg.merge_drain_words(
        mg.MergeBuffer(words=T(queue)), T(words), now0=T(now0), rate=4,
        use_pallas=True)
    same(jbuf.words, buf.words, "queue")
    same(jout, out, "out")
    same(jdrop, drop, "dropped")
    assert int(drop.sum()) > 0


def test_merge_step_pallas_matches_jax():
    """The SoA view over four cycles, as the reference's own test runs it."""
    rng = np.random.default_rng(1)
    addr = rng.integers(0, 256, (48,)).astype(np.int32)
    dead = rng.integers(0, 16, (48,)).astype(np.int32)
    valid = rng.random(48) < 0.7
    jbuf, buf = jmg.merge_init(16), mg.merge_init(16)
    for _ in range(4):
        jbuf, jout, jdrop = jmg.merge_step(
            jbuf, *map(jnp.asarray, (addr, dead, valid)), rate=5,
            use_pallas=True)
        buf, out, drop = mg.merge_step(buf, *map(T, (addr, dead, valid)),
                                       rate=5, use_pallas=True)
        same(jbuf.words, buf.words, "queue")
        for w, g in zip(jout, out):
            same(w, g)
        assert int(jdrop) == int(drop)
        addr, dead, valid = (np.zeros_like(x) for x in (addr, dead, valid))


# ---------------------------------------------------------------------------
# fused_lif_inject
# ---------------------------------------------------------------------------

def _lif_inject_case(b, seed):
    rng = np.random.default_rng(seed)
    n = 24
    v = rng.normal(0.2, 0.8, (N_CHIPS, n)).astype(np.float32)
    refrac = rng.choice([0, 0, 0, 2], (N_CHIPS, n)).astype(np.int32)
    cur = rng.normal(0.8, 1.0, (b, N_CHIPS, n)).astype(np.float32)
    params = jnr.LIFParams(
        tau_m=rng.choice([5.0, 10.0, 20.0], (N_CHIPS, n)).astype(np.float32),
        v_th=np.full((N_CHIPS, n), 1.0, np.float32),
        v_reset=np.zeros((N_CHIPS, n), np.float32),
        v_rest=np.zeros((N_CHIPS, n), np.float32),
        refrac=np.full((N_CHIPS, n), 2, np.int32))
    table = jrt.RoutingTable(
        dest_chip=rng.integers(0, N_CHIPS, (N_CHIPS, n, 1)).astype(np.int32),
        dest_addr=rng.integers(0, n, (N_CHIPS, n, 1)).astype(np.int32),
        delay=rng.integers(max(2, b), 13, (N_CHIPS, n, 1)).astype(np.int32),
        valid=rng.random((N_CHIPS, n, 1)) < 0.9)
    t0 = np.array([0, 120, 250], np.int32)
    return v, refrac, cur, params, table, t0


@pytest.mark.parametrize("mode", ["simplified", "full"])
@pytest.mark.parametrize("b", [1, 4])
def test_fused_lif_inject_plain_matches_pallas_interpret(b, mode):
    """Chip by chip against the TPU kernel, event_capacity 4 below the 24
    neurons so the cut bites."""
    v, refrac, cur, params, table, t0 = _lif_inject_case(b, 10 * b + len(mode))
    kw = dict(event_capacity=4, n_chips=N_CHIPS, buckets_per_chip=2,
              capacity=3, mode=mode, time_window=4)
    want = jax.vmap(
        lambda v_, r_, c_, p_, tb, t: jfi.fused_lif_inject(
            v_, r_, c_, p_, tb, None, t, interpret=True, **kw),
        in_axes=(0, 0, 1, 0, 0, 0))(
        jnp.asarray(v), jnp.asarray(refrac), jnp.asarray(cur),
        jnr.LIFParams(*map(jnp.asarray, params)),
        jrt.RoutingTable(*map(jnp.asarray, table)), jnp.asarray(t0))
    got = fi.fused_lif_inject(
        T(v), T(refrac), T(cur), nr.LIFParams(*map(T, params)),
        rt.RoutingTable(*map(T, table)), T(t0), **kw)
    same(want.refrac, got.refrac, "refrac")
    same(np.swapaxes(np.asarray(want.spikes), 0, 1), got.spikes, "spikes")
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(
        got.voltage.numpy(), np.swapaxes(np.asarray(want.voltage), 0, 1),
        rtol=0, atol=1e-5)
    same(want.inject.slab, got.inject.slab, "slab")
    for f in ("counts", "sent", "overflow", "wrap_expired", "traffic"):
        same(np.swapaxes(np.asarray(getattr(want.inject, f)), 0, 1),
             getattr(got.inject, f), f)
    np.testing.assert_array_equal(np.asarray(want.inject.lost), 0)
    fired = got.spikes.sum(-1)
    assert bool((fired > 4).any()), "the event_capacity cut never bit"
    assert int(got.inject.sent.sum()) > 0


def test_fused_lif_inject_rejects_fanout_above_one():
    v, refrac, cur, params, table, t0 = _lif_inject_case(1, 0)
    wide = rt.RoutingTable(*(torch.cat([T(x)] * 2, -1) for x in table))
    with pytest.raises(ValueError, match="fanout 1"):
        fi.fused_lif_inject(T(v), T(refrac), T(cur),
                            nr.LIFParams(*map(T, params)), wide, T(t0),
                            event_capacity=6, n_chips=N_CHIPS,
                            buckets_per_chip=1, capacity=4)


def _reach():
    """A reach table with unreachable pairs: chip 1 reaches only itself,
    chip 0 does not reach chip 2."""
    reach = np.ones((N_CHIPS, N_CHIPS), bool)
    reach[1, [0, 2]] = False
    reach[0, 2] = False
    return reach


def _check_inject_fields(want, got):
    """Every field of the inject outputs, ``lost`` included (JAX's are
    chip-first, the port's substep-first)."""
    same(want.slab, got.slab, "slab")
    for f in ("counts", "sent", "overflow", "wrap_expired", "lost",
              "traffic"):
        same(np.swapaxes(np.asarray(getattr(want, f)), 0, 1),
             getattr(got, f), f)


@pytest.mark.parametrize("mode", ["simplified", "full"])
@pytest.mark.parametrize("b", [1, 4])
def test_fused_inject_with_reach_plain_matches_pallas_interpret(b, mode):
    """The reach cull against the TPU kernel: lanes to an unreachable
    in-range chip drop into ``lost`` (never also ``wrap_expired``, though
    some of their deadlines fall outside the window), destinations one
    past the last chip keep their drop at the exchange."""
    rng = np.random.default_rng(40 + b + len(mode))
    n, e = 24, 20
    t0 = np.array([0, 120, 250], np.int32)
    addr = rng.integers(-3, n + 3, (b, N_CHIPS, e)).astype(np.int32)
    time = (t0[None, :, None]
            + rng.integers(0, b + 1, (b, N_CHIPS, e))).astype(np.int32)
    valid = rng.random((b, N_CHIPS, e)) < 0.8
    table = jrt.RoutingTable(
        dest_chip=rng.integers(0, N_CHIPS + 1, (N_CHIPS, n, 1)).astype(
            np.int32),
        dest_addr=rng.integers(0, n, (N_CHIPS, n, 1)).astype(np.int32),
        delay=rng.choice([1, 3, 9, 12, 130], (N_CHIPS, n, 1)).astype(
            np.int32),
        valid=rng.random((N_CHIPS, n, 1)) < 0.9)
    reach = _reach()
    kw = dict(n_chips=N_CHIPS, buckets_per_chip=2, capacity=3, mode=mode,
              time_window=4)
    want = jax.vmap(
        lambda e_, tb, r, t: jfi.fused_inject(e_, tb, r, t, interpret=True,
                                              **kw),
        in_axes=(1, 0, 0, 0))(
        jev.EventBuffer(*map(jnp.asarray, (addr, time, valid))),
        jrt.RoutingTable(*map(jnp.asarray, table)), jnp.asarray(reach),
        jnp.asarray(t0))
    got = fi.fused_inject(ev.EventBuffer(T(addr), T(time), T(valid)),
                          rt.RoutingTable(*map(T, table)), T(t0),
                          reach=T(reach), **kw)
    _check_inject_fields(want, got)
    assert int(got.lost.sum()) > 0 and int(got.wrap_expired.sum()) > 0
    assert int(got.lost[:, 1].sum()) > 0


@pytest.mark.parametrize("mode", ["simplified", "full"])
@pytest.mark.parametrize("b", [1, 4])
def test_fused_lif_inject_with_reach_plain_matches_pallas_interpret(b, mode):
    """``fused_lif_inject`` with a reach row, chip by chip against the
    TPU kernel, ``lost`` included."""
    v, refrac, cur, params, table, t0 = _lif_inject_case(b, 20 * b + len(mode))
    reach = _reach()
    kw = dict(event_capacity=4, n_chips=N_CHIPS, buckets_per_chip=2,
              capacity=3, mode=mode, time_window=4)
    want = jax.vmap(
        lambda v_, r_, c_, p_, tb, re, t: jfi.fused_lif_inject(
            v_, r_, c_, p_, tb, re, t, interpret=True, **kw),
        in_axes=(0, 0, 1, 0, 0, 0, 0))(
        jnp.asarray(v), jnp.asarray(refrac), jnp.asarray(cur),
        jnr.LIFParams(*map(jnp.asarray, params)),
        jrt.RoutingTable(*map(jnp.asarray, table)), jnp.asarray(reach),
        jnp.asarray(t0))
    got = fi.fused_lif_inject(
        T(v), T(refrac), T(cur), nr.LIFParams(*map(T, params)),
        rt.RoutingTable(*map(T, table)), T(t0), reach=T(reach), **kw)
    same(np.swapaxes(np.asarray(want.spikes), 0, 1), got.spikes, "spikes")
    _check_inject_fields(want.inject, got.inject)
    assert int(got.inject.lost.sum()) > 0


def test_lif_launch_plan_at_the_feedforward_cell():
    """Both fused kernels run one CTA of 512 threads per (chip, substep),
    a grid of (46, B): the inject scratch (a lane index per cell, each
    warp's counts by bucket and chip and its three stats, the running
    counts), for ``fused_lif_inject`` the spike counts of two tiles and
    the fired flags, and with a reach table the chip's row (46 bytes)."""
    assert fi.launch_plan(512, 46, 92, 32) == (512, 21168)
    assert fi.lif_launch_plan(512, 46, 92, 32) == (512, 21808)
    assert fi.launch_plan(512, 46, 92, 32, True) == (512, 21214)
    assert fi.lif_launch_plan(512, 46, 92, 32, True) == (512, 21854)
    assert ms.launch_plan(3136, "words") == (1024, 46604)
    assert ms.launch_plan(3136, "soa") == (1024, 71560)
    with pytest.raises(ValueError, match="shared memory"):
        ms.launch_plan(40000, "soa")


@pytest.mark.parametrize("kind,lanes,threads,smem", [
    ("words", 1, 32, 2196), ("words", 127, 128, 5784),
    ("words", 129, 160, 6820), ("words", 32768, 1024, 165132),
    ("soa", 1, 32, 2196), ("soa", 16384, 1024, 230536)])
def test_merge_sort_launch_plan_shared_memory(kind, lanes, threads, smem):
    """One warp per 32 lanes up to 32; shared memory is the block
    histogram (257 or 256 bins x (warps + 1) ints), 136 B of scratch and
    4 B (words) or 12 B (SoA) per lane, within a Hopper block's 227 KB."""
    assert ms.launch_plan(lanes, kind) == (threads, smem)
    assert smem <= kc.MAX_SMEM


@pytest.mark.parametrize("kind,limit", [("words", 32768), ("soa", 16384)])
def test_merge_sort_launch_plan_refuses_rows_past_the_limit(kind, limit):
    assert ms.MAX_LANES[kind] == limit
    assert ms.launch_plan(limit, kind)[0] == 1024
    with pytest.raises(ValueError, match=f"{limit} lanes"):
        ms.launch_plan(limit + 1, kind)
