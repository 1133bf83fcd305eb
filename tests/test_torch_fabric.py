"""Port parity, fabric: ``repro_torch.core.fabric.PulseFabric.superstep``
on the local path against the JAX fabric (``transport="local"``, unfused
chain), block by block, on the CPU.

Bitwise on the delay ring and its clock, the delivered words, the merge
queue and every integer ``CommStats`` field; ``utilization`` (an f32 mean)
within one f32 ulp.  B in {1, 2, 4, 8} x simplified / full (merge_rate 0
and 3) x fan-out 1 (``fused_inject``) and 4 (``bucket_pack``), with a
small bucket capacity (overflow), delays from 1 (admission-window
expiry at B > 1), a short merge queue (congestion drops) and a clock that
crosses the 8-bit wrap.
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
from repro_torch import convert  # noqa: E402
from repro_torch.core import delays as dl  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import fabric as fb  # noqa: E402
from repro_torch.core import pulse_comm as pc  # noqa: E402

N_CHIPS, N, STEPS, T0 = 4, 32, 8, 250


def T(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def same(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want), got.numpy(), err_msg=msg)


def _setup(b, mode, rate, fanout, seed=0):
    kw = dict(n_chips=N_CHIPS, neurons_per_chip=N, n_inputs_per_chip=N,
              event_capacity=N, fanout=fanout, bucket_capacity=4,
              buckets_per_chip=2, ring_depth=16, mode=mode, merge_rate=rate,
              merge_depth=8, superstep=b)
    table = jrt.random_table(jax.random.PRNGKey(seed), N, N_CHIPS,
                             fanout=fanout, min_delay=1, max_delay=14)
    tables = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (N_CHIPS,) + x.shape), table)
    rng = np.random.default_rng(seed)
    spikes = rng.random((STEPS, N_CHIPS, N)) < 0.35
    events = [jax.vmap(lambda s: jev.from_spikes(s, T0 + t, N)[0])(
        jnp.asarray(spikes[t])) for t in range(STEPS)]
    events = jev.EventBuffer(*(np.stack([np.asarray(getattr(e, f))
                                         for e in events])
                               for f in jev.EventBuffer._fields))
    return jpc.PulseCommConfig(**kw), pc.PulseCommConfig(**kw), tables, events


def _check_stats(want, got, where):
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f == "utilization":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-7,
                                       err_msg=f"{f} {where}")
        else:
            np.testing.assert_array_equal(w, g, err_msg=f"{f} {where}")


@pytest.mark.parametrize("fanout", [1, 4])
@pytest.mark.parametrize("mode,rate", [("simplified", 0), ("full", 0),
                                       ("full", 3)])
@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_superstep_matches_jax_fabric_bitwise(b, mode, rate, fanout):
    jcfg, cfg, jtables, events = _setup(b, mode, rate, fanout)
    jfab = jfb.PulseFabric(jcfg, transport="local")
    run = jfab.jit_superstep()
    fab = fb.PulseFabric(cfg, device="cpu")
    jring = jax.vmap(lambda _: jdl.init(16, N, now=T0))(jnp.arange(N_CHIPS))
    ring = dl.init(16, N, now=T0, batch_shape=(N_CHIPS,))
    tables = convert.table_from_jax(jtables, device="cpu")
    jmerge, merge = jfab.init_merge(), fab.init_merge()
    totals = np.zeros(4, np.int64)
    for blk in range(STEPS // b):
        sl = slice(blk * b, (blk + 1) * b)
        block = [x[sl] for x in events]
        jres = run(jev.EventBuffer(*map(jnp.asarray, block)), jtables, jring,
                   None, jmerge)
        res = fab.superstep(ev.EventBuffer(*map(T, block)), tables, ring,
                            None, merge)
        where = f"block {blk}"
        same(jres.ring.ring, res.ring.ring, f"ring {where}")
        same(jres.ring.now, res.ring.now, f"clock {where}")
        same(jres.delivered.words, res.delivered.words, f"words {where}")
        _check_stats(jres.stats, res.stats, where)
        if rate:
            same(jres.merge.words, res.merge.words, f"merge queue {where}")
        jring = jdl.DelayRing(ring=jres.ring.ring, now=jres.ring.now + b)
        ring = dl.DelayRing(ring=res.ring.ring, now=res.ring.now + b)
        jmerge, merge = jres.merge, res.merge
        s = res.stats
        totals += [int(s.sent.sum()), int(s.overflow.sum()),
                   int(s.expired.sum()), int(s.merge_dropped.sum())]
    assert totals[0] > 0 and totals[1] > 0   # traffic, and bucket overflow
    if rate:
        assert totals[3] > 0                 # merge congestion drops


def test_step_matches_jax_fabric_step():
    jcfg, cfg, jtables, events = _setup(1, "full", 3, 1, seed=3)
    jfab = jfb.PulseFabric(jcfg, transport="local")
    fab = fb.PulseFabric(cfg, device="cpu")
    jring = jax.vmap(lambda _: jdl.init(16, N, now=T0))(jnp.arange(N_CHIPS))
    jres = jfab.jit_step()(
        jev.EventBuffer(*(jnp.asarray(x[0]) for x in events)), jtables, jring)
    res = fab.step(ev.EventBuffer(*(T(x[0]) for x in events)),
                   convert.table_from_jax(jtables, device="cpu"),
                   dl.init(16, N, now=T0, batch_shape=(N_CHIPS,)))
    same(jres.ring.ring, res.ring.ring, "ring")
    same(jres.delivered.words, res.delivered.words, "words")
    same(jres.merge.words, res.merge.words, "merge queue")
    _check_stats(jres.stats, res.stats, "step")


def test_fabric_guards():
    _, cfg, jtables, events = _setup(2, "simplified", 0, 1)
    fab = fb.PulseFabric(cfg, device="cpu")
    ring = dl.init(16, N, batch_shape=(N_CHIPS,))
    tables = convert.table_from_jax(jtables, device="cpu")
    with pytest.raises(ValueError, match="substeps"):
        fab.superstep(ev.EventBuffer(*(T(x[:1]) for x in events)), tables,
                      ring)
    with pytest.raises(ValueError, match="superstep"):
        fab.step(ev.EventBuffer(*(T(x[0]) for x in events)), tables, ring)
    with pytest.raises(ValueError, match=r"\[F, B=2"):
        fab.run_pipelined(ev.EventBuffer(*(T(x[:2]) for x in events)),
                          tables, ring)


@pytest.mark.parametrize("kw", [dict(transport="shard_map"),
                                dict(transport=("pod", "chip")),
                                dict(transport="shard_map", healthy=[0, 1])])
def test_shard_transports_need_a_process_group(kw):
    """The shard transports (held in tests/test_torch_transport.py and
    tests/test_torch_shard.py, in gloo processes) raise without a
    process group rather than run the local exchange; an unknown spec is
    refused."""
    assert not torch.distributed.is_initialized()
    cfg = pc.PulseCommConfig(n_chips=4)
    with pytest.raises(RuntimeError, match="init_process_group"):
        fb.PulseFabric(cfg, device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown transport"):
        fb.PulseFabric(cfg, "shard", device="cpu")
