"""Port parity, the shard forms (counterpart of the reference's
``shard_step`` / ``shard_superstep`` / ``shard_pipeline_block`` /
``shard_flush_pending``): each case runs in gloo processes on the CPU,
at world 4 (one chip a rank, the reference's layout) and at world 2 (two
chips a rank), from shard-local params and state cut by
``network.shard_slice``; the ranks' records and final states, put side
by side, equal JAX's local ``net.run`` from the same params and inputs:
spikes equal, every integer stat, the rings, merge queues, credits and
send queues bitwise, voltages within 1e-5 (``exp`` differs in the last
bit between PyTorch and XLA, see tests/test_torch_network.py),
``utilization`` within 1e-7.

Cases, 4 chips x 16 neurons: ``shard_step`` at B 1 (simplified, fan-out
2); ``shard_superstep`` at B 4 (full, merge_rate 3); the pipelined
schedule (``shard_pipeline_block`` then ``shard_flush_pending``, stats
realigned); credit flow control with the send queue (non-empty at the
end); routed through ``torus2d(2, 2)`` and ``switch_tree(2, 2)``; and
degraded (chip 3 dead, link (0, 0) cut, words lost to failure).  Also
the psum heartbeat with chip 1 silent against ``beats_local``, and the
reference's guards.

The JAX runs happen once, in this process; the gloo children are
spawned once per world size by a module-scoped fixture and import no
JAX (tests/torch_dist.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import fabric as jfb  # noqa: E402
from repro.core import pulse_comm as jpc  # noqa: E402
from repro.core import resilience as jrsl  # noqa: E402
from repro.core import topology as jtp  # noqa: E402
from repro.snn import network as jnet  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import fabric as fb  # noqa: E402
from repro_torch.core import pulse_comm as pc  # noqa: E402
from repro_torch.core import resilience as rsl  # noqa: E402
from repro_torch.snn import network as net  # noqa: E402
import torch_dist  # noqa: E402

N_CHIPS, N = 4, 16
ALIVE = np.array([1, 0, 1, 1], np.int32)        # chip 1 silent
BASE = dict(n_chips=N_CHIPS, neurons_per_chip=N, n_inputs_per_chip=N,
            event_capacity=N, bucket_capacity=8, ring_depth=16)
FULL = dict(fanout=1, mode="full", buckets_per_chip=2, merge_rate=3,
            merge_depth=8)

# name: (form, comm kw, network kw (JAX objects), T, input rate)
CASES = {
    "step": ("step", dict(superstep=1, fanout=2, mode="simplified"), {},
             8, 0.3),
    "superstep": ("superstep", dict(superstep=4, **FULL), {}, 16, 0.3),
    "pipeline": ("pipeline", dict(superstep=2, **FULL),
                 dict(pipeline=True), 12, 0.3),
    "flow": ("superstep", dict(superstep=2, **FULL),
             dict(flow=(2, 1, 6)), 12, 0.6),
    "torus": ("superstep", dict(superstep=2, ring_depth=20, **FULL),
              dict(topology=jtp.torus2d(2, 2, link_latency=1)), 12, 0.3),
    "tree": ("superstep", dict(superstep=2, ring_depth=20, **FULL),
             dict(topology=jtp.switch_tree(2, 2, link_latency=1,
                                           link_bandwidth=4)), 12, 0.3),
    "degraded": ("superstep", dict(superstep=2, ring_depth=20, **FULL),
                 dict(topology=jtp.torus2d(2, 2, link_latency=1),
                      healthy=(0, 1, 2), dead_links=((0, 0),)), 12, 0.3),
}
WORLDS = (4, 2)


def _configs(comm_kw, net_kw):
    """The JAX and the port's NetworkConfig of one case."""
    comm = {**BASE, **comm_kw}
    jkw, kw = dict(net_kw), dict(net_kw)
    if "flow" in net_kw:
        cap, rate, depth = net_kw["flow"]
        jkw["flow"] = jfb.FlowControlConfig(capacity=cap, drain_rate=rate,
                                            retransmit_depth=depth)
        kw["flow"] = fb.FlowControlConfig(capacity=cap, drain_rate=rate,
                                          retransmit_depth=depth)
    if "topology" in net_kw:
        kw["topology"] = convert.topology_from_jax(net_kw["topology"])
    return (jnet.NetworkConfig(comm=jpc.PulseCommConfig(**comm), **jkw),
            net.NetworkConfig(comm=pc.PulseCommConfig(**comm), **kw))


def _jax_case(seed, form, comm_kw, net_kw, t, rate):
    jcfg, cfg = _configs(comm_kw, net_kw)
    jparams = jnet.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    w = np.round(rng.normal(0, 0.5, (N_CHIPS, N, N)) * 16) / 16  # dyadic
    jparams = jparams._replace(crossbar=jparams.crossbar._replace(
        w=jnp.asarray(w, jnp.float32)))
    ext = (rng.random((t, N_CHIPS, N)) < rate).astype(np.float32) * 3
    jfinal, jrec = jax.jit(lambda p, s, e: jnet.run(jcfg, p, s, e))(
        jparams, jnet.init_state(jcfg, jparams), jnp.asarray(ext))
    case = dict(form=form, cfg=cfg, ext=ext,
                params=convert.params_from_jax(jparams, device="cpu"))
    return case, (jfinal, jrec)


@pytest.fixture(scope="module")
def shard_runs(tmp_path_factory):
    cases, refs = {}, {}
    for i, (name, spec) in enumerate(CASES.items()):
        cases[name], refs[name] = _jax_case(i, *spec)
    tmp = tmp_path_factory.mktemp("shard")
    runs = {w: torch_dist.spawn(torch_dist.shard_worker, w, tmp, cases,
                                ALIVE) for w in WORLDS}
    return cases, refs, runs


def _side_by_side(ranks, get, axis):
    return torch.cat([get(r) for r in ranks], dim=axis).numpy()


def same(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


@pytest.mark.parametrize("world", WORLDS, ids=["world4", "world2"])
@pytest.mark.parametrize("name", list(CASES))
def test_shard_form_equals_the_jax_local_run(shard_runs, name, world):
    cases, refs, runs = shard_runs
    jfinal, jrec = refs[name]
    ranks = [r[name] for r in runs[world]]
    def rec(f):
        return _side_by_side(ranks, lambda r: r["record"][f], 1)

    same(jrec.spikes, rec("spikes"), "spikes")
    np.testing.assert_allclose(rec("voltage"), np.asarray(jrec.voltage),
                               rtol=0, atol=1e-5)
    for f in jrec.stats._fields:
        got = _side_by_side(ranks, lambda r: r["record"]["stats"][f], 1)
        want = np.asarray(getattr(jrec.stats, f))
        if f == "utilization":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        else:
            same(want, got, f)
    def fin(k):
        return _side_by_side(ranks, lambda r: r["final"][k], 0)

    same(jfinal.ring.ring, fin("ring"), "ring")
    same(jfinal.ring.now, fin("now"), "now")
    assert all(int(r["final"]["t"]) == int(jfinal.t) for r in ranks)
    np.testing.assert_allclose(fin("v"), np.asarray(jfinal.neuron.v),
                               rtol=0, atol=1e-5)
    if jfinal.merge is not None:
        same(jfinal.merge.words, fin("merge"), "merge queue")
    if jfinal.flow is not None:
        for f in jfinal.flow._fields:
            same(getattr(jfinal.flow, f), fin(f"flow.{f}"), f"flow.{f}")
    if jfinal.sendq is not None:
        same(jfinal.sendq.words, fin("sendq_words"), "send queue")
        same(jfinal.sendq.dest, fin("sendq_dest"), "send queue dest")
    assert int(np.asarray(jrec.stats.sent).sum()) > 0
    if name == "flow":
        assert int((np.asarray(jfinal.sendq.words) >= 0).sum()) > 0
        assert int(np.asarray(jrec.stats.stalled).sum()) >= 0
    if name == "degraded":
        assert int(np.asarray(jrec.stats.lost_to_failure).sum()) > 0
    if name in ("torus", "tree", "degraded"):
        assert int(np.asarray(jrec.stats.link_words).sum()) > 0


@pytest.mark.parametrize("world", WORLDS, ids=["world4", "world2"])
def test_heartbeat_equals_beats_local(shard_runs, world):
    """Each rank's psum heartbeat (of its explicit transport, and of the
    world's chip mesh) equals ``beats_local`` of the whole alive vector,
    chip 1 silent; the reference's local heartbeat agrees."""
    _, _, runs = shard_runs
    want = rsl.beats_local(torch.as_tensor(ALIVE))
    same(jrsl.beats_local(jnp.asarray(ALIVE)), want)
    for r in runs[world]:
        same(r["heartbeat"], want)
        same(r["heartbeat_none"], want)
        assert r["heartbeat"].dtype == torch.int32


@pytest.mark.parametrize("world", WORLDS, ids=["world4", "world2"])
def test_shard_guards_inside_a_process_group(shard_runs, world):
    """A chip count the world does not divide, and full (unsliced) params
    on a rank, are refused."""
    _, _, runs = shard_runs
    for r in runs[world]:
        assert r["errors"]["uneven"].startswith("ValueError"), r["errors"]
        assert "split evenly" in r["errors"]["uneven"]
        assert r["errors"]["rows"].startswith("ValueError"), r["errors"]
        assert "shard_slice" in r["errors"]["rows"]


# ---------------------------------------------------------------------------
# Guards that need no process group, and shard_slice
# ---------------------------------------------------------------------------

def _small(**kw):
    comm = pc.PulseCommConfig(**{**BASE, "superstep": kw.pop("b", 1)})
    cfg = net.NetworkConfig(comm=comm, **kw)
    params = net.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    return cfg, params, net.init_state(cfg, params, device="cpu")


def test_shard_step_refuses_a_superstep():
    cfg, params, state = _small(b=2)
    with pytest.raises(ValueError, match="shard_superstep"):
        net.shard_step(cfg, "chip", params, state, torch.zeros(4, N),
                       mesh=None)


def test_shard_pipeline_block_needs_the_pipeline():
    cfg, params, state = _small(b=2)
    with pytest.raises(ValueError, match="pipeline=True"):
        net.shard_pipeline_block(cfg, "chip", params, state,
                                 torch.zeros(2, 4, N), mesh=None)


def test_shard_forms_refuse_the_dense_path():
    cfg, params, state = _small(comm_mode="dense")
    with pytest.raises(ValueError, match="dense"):
        net.shard_superstep(cfg, "chip", params, state,
                            torch.zeros(1, 4, N), mesh=None)


@pytest.mark.parametrize("n_local", [1, 2])
def test_shard_slice_cuts_every_chip_leaf(n_local):
    """``shard_slice`` cuts params and state (the pipeline carry's block
    stats on their chip axis) to a rank's rows; the ranks' slices side by
    side give the full tree back; the clock stays whole."""
    cfg, params, state = _small(b=2, pipeline=True,
                                flow=fb.FlowControlConfig(
                                    retransmit_depth=3))
    cfg = dataclasses.replace(cfg, telemetry=True)
    state = net.init_state(cfg, params, device="cpu")
    fabric = net.local_fabric(cfg, device="cpu")
    state = state._replace(pending=fabric.init_pending())
    parts = [net.shard_slice((params, state), r, n_local)
             for r in range(N_CHIPS // n_local)]
    from repro_torch.checkpoint.store import tree_flatten_with_path
    full, _ = tree_flatten_with_path((params, state))
    cuts = [tree_flatten_with_path(p)[0] for p in parts]
    for i, (path, leaf) in enumerate(full):
        got = [c[i][1] for c in cuts]
        if leaf.dim() == 0 or "metrics" in path:
            assert all(g is leaf for g in got), path
            continue
        axis = 1 if "inject" in path else 0
        assert got[0].shape[axis] == n_local, path
        same(torch.cat(got, dim=axis), leaf, str(path))
