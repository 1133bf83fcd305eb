"""Port parity, checkpoints (``repro_torch.checkpoint``): the cases of
tests/test_checkpoint.py on the port's store, and the two stores against
each other on the CPU.  The reshard onto another mesh
(``restore(..., shardings=)``, DTensors) and the save of DTensor leaves
run in 3 gloo processes (tests/torch_dist.py).

A checkpoint written by either store restores through the other: the
same leaf keys (field names, sorted dict keys, sequence indices), the
same manifest and byte-equal ``.npy`` files, bfloat16 as a ``uint16``
view under its logical name.  Values are compared bitwise.
"""

import filecmp
import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core import fabric as jfb  # noqa: E402
from repro.core import pulse_comm as jpc  # noqa: E402
from repro.core import routing as jrt  # noqa: E402
from repro.core import topology as jtp  # noqa: E402
from repro.snn import network as jnet  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import merge as mg  # noqa: E402
from repro_torch.core import pulse_comm as pc  # noqa: E402
from repro_torch.core import routing as rt  # noqa: E402
from repro_torch.snn import network as net  # noqa: E402
import torch_dist  # noqa: E402

CPU = torch.device("cpu")


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32),
            "o": rng.standard_normal(3).astype(np.float32)}


def _tree(seed):
    """The reference test's tree: nested dicts, a list, a bf16 leaf and a
    0-d int32."""
    a = _arrays(seed)
    return {
        "params": {"w": torch.from_numpy(a["w"]),
                   "b": torch.from_numpy(a["b"]).to(torch.bfloat16)},
        "opt": [torch.arange(5, dtype=torch.int32), torch.from_numpy(a["o"])],
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _jax_tree(seed):
    a = _arrays(seed)
    return {
        "params": {"w": jnp.asarray(a["w"]),
                   "b": jnp.asarray(a["b"]).astype(jnp.bfloat16)},
        "opt": [jnp.arange(5, dtype=jnp.int32), jnp.asarray(a["o"])],
        "step": jnp.asarray(7, jnp.int32),
    }


def _host(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


def _assert_tree_equal(a, b):
    la, lb = ckpt.tree_leaves(a), ckpt.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(_host(x), _host(y))


# ---------------------------------------------------------------------------
# The reference's cases on the port's store
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    tree = _tree(0)
    ckpt.save(tree, str(tmp_path), 42)
    assert ckpt.latest_step(str(tmp_path)) == 42
    out = ckpt.restore(str(tmp_path), 42, tree)
    _assert_tree_equal(tree, out)
    assert out["params"]["b"].dtype == torch.bfloat16
    assert out["step"].shape == () and out["step"].dtype == torch.int32


def test_restore_into_shape_structs(tmp_path):
    """Tensors on the ``meta`` device stand for JAX's ShapeDtypeStructs:
    shape and dtype, no data; the leaves come back on the CPU."""
    tree = _tree(1)
    ckpt.save(tree, str(tmp_path), 1)
    target = ckpt.tree_map(lambda x: torch.empty_like(x, device="meta"),
                           tree)
    out = ckpt.restore(str(tmp_path), 1, target)
    _assert_tree_equal(tree, out)
    assert all(x.device == CPU for x in ckpt.tree_leaves(out))


def test_uncommitted_checkpoint_invisible(tmp_path):
    ckpt.save(_tree(2), str(tmp_path), 5)
    os.makedirs(ckpt.step_dir(str(tmp_path), 9) + ".tmp")
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_gc_retention(tmp_path):
    tree = _tree(3)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tree, str(tmp_path), s)
    ckpt.gc_old(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert not os.path.exists(ckpt.step_dir(str(tmp_path), 3))
    _assert_tree_equal(tree, ckpt.restore(str(tmp_path), 4, tree))


def test_async_checkpointer(tmp_path):
    tree = _tree(4)
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    for s in (10, 20):
        w.save(tree, s)
    w.close()
    assert ckpt.latest_step(str(tmp_path)) == 20
    _assert_tree_equal(tree, ckpt.restore(str(tmp_path), 10, tree))


def test_async_snapshot_is_not_reached_by_a_later_in_place_op(tmp_path):
    """``save`` copies to host memory before it returns: an in-place op on
    the caller's tensors right after it does not reach the checkpoint."""
    big = torch.zeros((512, 1024))
    tree = {"big": big, "t": torch.tensor(3, dtype=torch.int32)}
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    for s in range(4):
        w.save(tree, s)
        big.add_(1.0)
        tree["t"].add_(1)
    w.close()
    for s in range(4):
        out = ckpt.restore(str(tmp_path), s, tree)
        assert float(out["big"].min()) == float(out["big"].max()) == s
        assert int(out["t"]) == 3 + s


def test_shape_mismatch_raises(tmp_path):
    tree = _tree(5)
    ckpt.save(tree, str(tmp_path), 0)
    bad = dict(tree)
    bad["params"] = {"w": torch.zeros((9, 4)), "b": tree["params"]["b"]}
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 0, bad)


def test_network_state_with_merge_queue_roundtrip(tmp_path):
    """A full-mode NetworkState (merge queue and all) saved mid-volley
    restores bit for bit, and resuming from it reproduces the
    uninterrupted run."""
    n = 12
    comm = pc.PulseCommConfig(
        n_chips=2, neurons_per_chip=n, n_inputs_per_chip=n,
        event_capacity=n, bucket_capacity=n, ring_depth=16,
        mode="full", merge_rate=3, merge_depth=32)
    cfg = net.NetworkConfig(comm=comm)
    table = rt.feedforward_table(n, src_chip=0, dst_chip=1, delay=8)
    params = net.init_params(torch.Generator().manual_seed(0), cfg,
                             table=table, device="cpu")
    w = torch.stack([1.5 * torch.eye(n)] * 2)
    params = params._replace(crossbar=params.crossbar._replace(w=w))
    state = net.init_state(cfg, params, device="cpu")
    ext = torch.zeros((8, 2, n))
    ext[0, 0, :] = 1.0
    for t in range(2):
        state, _ = net.step(cfg, params, state, ext[t], device="cpu")
    assert int(state.merge.occupancy().sum()) > 0

    ckpt.save(state, str(tmp_path), 2)
    restored = ckpt.restore(str(tmp_path), 2, state)
    _assert_tree_equal(state, restored)
    a, b = state, restored
    for t in range(2, 8):
        a, rec_a = net.step(cfg, params, a, ext[t], device="cpu")
        b, rec_b = net.step(cfg, params, b, ext[t], device="cpu")
        assert torch.equal(rec_a.spikes, rec_b.spikes)
    _assert_tree_equal(a, b)
    assert int(a.merge.occupancy().sum()) == 0


def test_pre_word_merge_checkpoint_raises_clear_error(tmp_path):
    class OldMergeBuffer(NamedTuple):
        addr: torch.Tensor
        deadline: torch.Tensor
        valid: torch.Tensor

    depth = 16
    old_state = {
        "ring": torch.zeros((4, 8), dtype=torch.int32),
        "merge": OldMergeBuffer(
            addr=torch.arange(depth, dtype=torch.int32),
            deadline=torch.arange(depth, dtype=torch.int32),
            valid=torch.ones((depth,), dtype=torch.bool)),
    }
    ckpt.save(old_state, str(tmp_path), 7)
    new_state = {"ring": torch.zeros((4, 8), dtype=torch.int32),
                 "merge": mg.merge_init(depth)}
    with pytest.raises(ValueError, match="pre-word-format"):
        ckpt.restore(str(tmp_path), 7, new_state)
    with pytest.raises(ValueError, match="init_merge"):
        ckpt.restore(str(tmp_path), 7, new_state, strict=False)


def test_strict_restore_rejects_extra_leaves(tmp_path):
    tree = _tree(6)
    ckpt.save(tree, str(tmp_path), 1)
    partial = {"params": tree["params"], "step": tree["step"]}
    with pytest.raises(ValueError, match="carries leaves"):
        ckpt.restore(str(tmp_path), 1, partial)
    _assert_tree_equal(partial, ckpt.restore(str(tmp_path), 1, partial,
                                             strict=False))


def test_restore_places_leaves_on_the_device_asked_for(tmp_path):
    """``device=`` overrides each target leaf's device (here ``meta``, the
    one device besides the CPU that every machine has); without it a
    leaf takes its target's device and dtype, a bool leaf stays bool and
    a 0-d leaf stays 0-d."""
    tree = {"mask": torch.tensor([True, False, True]),
            "t": torch.tensor(5, dtype=torch.int32), "x": torch.ones(3)}
    ckpt.save(tree, str(tmp_path), 0)
    out = ckpt.restore(str(tmp_path), 0, tree, device="meta")
    assert all(x.device.type == "meta" for x in ckpt.tree_leaves(out))
    out = ckpt.restore(str(tmp_path), 0,
                       ckpt.tree_map(torch.zeros_like, tree))
    assert out["mask"].dtype == torch.bool and out["t"].shape == ()
    _assert_tree_equal(tree, out)


# ---------------------------------------------------------------------------
# Across the two stores
# ---------------------------------------------------------------------------

class _Pair(NamedTuple):
    a: object
    b: object = None
    c: object = None


def test_leaf_keys_equal_jax_paths():
    """The port's flattening gives the keys of ``jax.tree_util.
    tree_flatten_with_path``: field names, sorted dict keys and sequence
    indices; ``None`` is an empty subtree."""
    port = {"z": [_Pair(torch.zeros(1), None, (torch.zeros(1),
                                               torch.zeros(1)))],
            "a": {"k2": torch.zeros(1), "k1": torch.zeros(1)}}
    jtree = {"z": [_Pair(jnp.zeros(1), None, (jnp.zeros(1), jnp.zeros(1)))],
             "a": {"k2": jnp.zeros(1), "k1": jnp.zeros(1)}}
    want, _ = jckpt.store._flatten_with_paths(jtree)
    got, _ = ckpt.store._flatten_with_paths(port)
    assert [k for k, *_ in got] == [k for k, _ in want] == [
        "a/k1", "a/k2", "z/0/a", "z/0/c/0", "z/0/c/1"]


def _same_files(d1, d2):
    names = sorted(os.listdir(d1))
    assert names == sorted(os.listdir(d2))
    for name in names:
        assert filecmp.cmp(os.path.join(d1, name), os.path.join(d2, name),
                           shallow=False), name


def test_both_stores_write_the_same_bytes(tmp_path):
    """The same tree through either store: equal manifests and byte-equal
    ``.npy`` files (bf16 as its ``uint16`` view)."""
    jckpt.save(_jax_tree(7), str(tmp_path / "jax"), 3)
    ckpt.save(_tree(7), str(tmp_path / "port"), 3)
    dj = jckpt.step_dir(str(tmp_path / "jax"), 3)
    dp = ckpt.step_dir(str(tmp_path / "port"), 3)
    _same_files(dj, dp)
    with open(os.path.join(dp, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["leaves"]["params/b"]["dtype"] == "bfloat16"
    assert np.load(os.path.join(
        dp, manifest["leaves"]["params/b"]["file"])).dtype == np.uint16


def test_jax_checkpoint_restores_through_the_port(tmp_path):
    jckpt.save(_jax_tree(8), str(tmp_path), 11)
    assert ckpt.latest_step(str(tmp_path)) == 11
    out = ckpt.restore(str(tmp_path), 11, _tree(0))
    _assert_tree_equal(_tree(8), out)
    assert out["params"]["b"].dtype == torch.bfloat16


def test_port_checkpoint_restores_through_jax(tmp_path):
    ckpt.save(_tree(9), str(tmp_path), 12)
    assert jckpt.latest_step(str(tmp_path)) == 12
    out = jckpt.restore(str(tmp_path), 12, _jax_tree(0))
    _assert_tree_equal(_jax_tree(9), out)
    assert out["params"]["b"].dtype == jnp.bfloat16


def _jax_network_state():
    """A JAX NetworkState mid-run with a merge queue, credits and a
    telemetry carry, on a ring topology (4 chips x 16)."""
    comm = jpc.PulseCommConfig(
        n_chips=4, neurons_per_chip=16, n_inputs_per_chip=16,
        event_capacity=16, bucket_capacity=4, ring_depth=16, mode="full",
        merge_rate=1)
    cfg = jnet.NetworkConfig(comm=comm, topology=jtp.ring(4, link_latency=1),
                             flow=jfb.FlowControlConfig(capacity=8),
                             telemetry=jobs.MetricsConfig(flight_depth=4))
    key = jax.random.PRNGKey(5)
    table = jrt.random_table(key, 16, 4, max_delay=8, min_delay=3)
    params = jnet.init_params(key, cfg, table=table)
    ext = 1.5 * (np.random.default_rng(5).random((6, 4, 16)) < 0.5)
    state, _ = jnet.run(cfg, params, jnet.init_state(cfg, params),
                        jnp.asarray(ext, jnp.float32))
    return state


def test_network_state_checkpoints_cross_the_two_stores(tmp_path):
    """A JAX network state (merge queue, credits, telemetry carry and
    flight ring) saved by the JAX store restores into the port's state
    through the port's store, equal to ``convert.state_from_jax``, and
    back: the port's save of it is byte for byte the JAX save."""
    jstate = _jax_network_state()
    assert int(np.asarray(jstate.merge.occupancy())) > 0
    want = convert.state_from_jax(jstate, device="cpu")
    jckpt.save(jstate, str(tmp_path / "jax"), 6)
    got = ckpt.restore(str(tmp_path / "jax"), 6,
                       ckpt.tree_map(torch.zeros_like, want))
    _assert_tree_equal(want, got)
    assert [f for f in got._fields if getattr(got, f) is not None][-1] \
        == "metrics"
    ckpt.save(got, str(tmp_path / "port"), 6)
    _same_files(jckpt.step_dir(str(tmp_path / "jax"), 6),
                ckpt.step_dir(str(tmp_path / "port"), 6))
    back = jckpt.restore(str(tmp_path / "port"), 6,
                         jax.tree.map(jnp.zeros_like, jstate))
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _jax_pipelined_state():
    """A JAX NetworkState between two pipelined blocks (4 chips x 16, B
    2): a carry with words in flight."""
    comm = jpc.PulseCommConfig(n_chips=4, neurons_per_chip=16,
                               n_inputs_per_chip=16, event_capacity=16,
                               bucket_capacity=16, ring_depth=32,
                               superstep=2)
    jcfg = jnet.NetworkConfig(comm=comm, pipeline=True)
    key = jax.random.PRNGKey(1)
    params = jnet.init_params(key, jcfg, table=jrt.random_table(
        key, 16, 4, max_delay=12, min_delay=6))
    jfab = jnet.local_fabric(jcfg)
    jstate = jnet._ensure_carries(jfab, jnet.init_state(jcfg, params),
                                  pipeline=True)
    block = jax.jit(lambda p, s, e: jnet._block_impl(
        jcfg, jfab, p.table, p.neuron, p.crossbar.w, s, e)[0])
    ext = 1.5 * (np.random.default_rng(1).random((4, 4, 16)) < 0.5)
    for f in range(2):
        jstate = block(params, jstate,
                       jnp.asarray(ext[2 * f:2 * f + 2], jnp.float32))
    assert int(np.asarray(jstate.pending.occupancy()).sum()) > 0
    return jstate


def test_pipelined_state_checkpoints_cross_the_two_stores(tmp_path):
    """A pipelined JAX state with words in flight, saved by the JAX store,
    restores into the port equal to ``convert.state_from_jax``; the
    port's save of it is byte for byte the JAX save (the carry's block
    stats, ``[B, n_chips]`` in the port, are written chip-first), and JAX
    restores it."""
    jstate = _jax_pipelined_state()
    want = convert.state_from_jax(jstate, device="cpu")
    assert tuple(want.pending.inject.sent.shape) == (2, 4)
    jckpt.save(jstate, str(tmp_path / "jax"), 2)
    got = ckpt.restore(str(tmp_path / "jax"), 2,
                       ckpt.tree_map(torch.zeros_like, want))
    _assert_tree_equal(want, got)
    assert int(got.pending.occupancy().sum()) > 0
    ckpt.save(got, str(tmp_path / "port"), 2)
    _same_files(jckpt.step_dir(str(tmp_path / "jax"), 2),
                ckpt.step_dir(str(tmp_path / "port"), 2))
    back = jckpt.restore(str(tmp_path / "port"), 2,
                         jax.tree.map(jnp.zeros_like, jstate))
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pipelined_state_save_restore_roundtrip(tmp_path):
    """The port's store alone: a pipelined state goes out and comes back
    bitwise with its carry's stats ``[B, n_chips]`` (the files hold them
    chip-first), and a target with the stats in the stored layout is
    refused with the leaf's name."""
    state = convert.state_from_jax(_jax_pipelined_state(), device="cpu")
    ckpt.save(state, str(tmp_path), 4)
    got = ckpt.restore(str(tmp_path), 4,
                       ckpt.tree_map(torch.zeros_like, state))
    _assert_tree_equal(state, got)
    manifest = json.load(open(os.path.join(ckpt.step_dir(str(tmp_path), 4),
                                           "manifest.json")))
    assert manifest["leaves"]["pending/inject/sent"]["shape"] == [4, 2]
    wrong = state._replace(pending=state.pending._replace(
        inject=pc.InjectStats(*(x.swapaxes(0, 1).contiguous()
                                for x in state.pending.inject))))
    with pytest.raises(ValueError, match="pending/inject/sent"):
        ckpt.restore(str(tmp_path), 4, wrong)


# ---------------------------------------------------------------------------
# Reshard on load and the save of DTensors, in 3 gloo processes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def resharded(tmp_path_factory):
    """A checkpoint written by the JAX store (``w [24, 4]``, ``b [8]``),
    restored by 3 ranks onto a chip mesh with ``w`` sharded and ``b``
    replicated, saved from the DTensors and restored again; beside it a
    single process's save of the same tree."""
    tmp = tmp_path_factory.mktemp("reshard")
    w = np.arange(96, dtype=np.float32).reshape(24, 4)
    b = np.arange(8, dtype=np.float32)
    jckpt.save({"w": jnp.asarray(w), "b": jnp.asarray(b)},
               str(tmp / "jax"), 4)
    ckpt.save({"w": torch.as_tensor(w), "b": torch.as_tensor(b)},
              str(tmp / "single"), 4)
    out = torch_dist.spawn(torch_dist.checkpoint_worker, 3, tmp,
                           str(tmp / "jax"), str(tmp / "dist"))
    return tmp, w, b, out


def test_elastic_reshard_on_load(resharded):
    """A JAX-written checkpoint loads onto a 3-rank chip mesh through
    ``restore(..., shardings=)``: DTensors with the values and the
    placements asked for, each rank holding its own rows."""
    _, w, b, out = resharded
    for r, o in enumerate(out):
        assert o["step"] == 4
        gw, gb = o["got"]["w"], o["got"]["b"]
        assert tuple(gw["local"].shape) == (8, 4)
        np.testing.assert_array_equal(gw["local"].numpy(), w[8 * r:8 * r + 8])
        np.testing.assert_array_equal(gw["full"].numpy(), w)
        assert gw["placements"] == ["Shard(dim=0)"] and gw["mesh"] == (3,)
        np.testing.assert_array_equal(gb["local"].numpy(), b)
        assert gb["placements"] == ["Replicate()"]


def test_dtensor_save_is_byte_equal_to_a_single_process_save(resharded):
    """Every rank saves the DTensors; rank 0 writes the full tensors, and
    the files equal a single process's save byte for byte; restoring
    them gives the same shards."""
    tmp, _, _, out = resharded
    _same_files(ckpt.step_dir(str(tmp / "dist"), 4),
                ckpt.step_dir(str(tmp / "single"), 4))
    assert ckpt.latest_step(str(tmp / "dist")) == 4
    for o in out:
        for k in ("w", "b"):
            for f in ("local", "full"):
                assert torch.equal(o["again"][k][f], o["got"][k][f])
            assert o["again"][k]["placements"] == o["got"][k]["placements"]
