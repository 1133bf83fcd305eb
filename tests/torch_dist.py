"""Workers of the port's multi-process tests (tests/test_torch_transport.py,
test_torch_shard.py, test_torch_checkpoint.py, test_torch_fault.py).

:func:`spawn` runs a worker in ``world`` child processes on the CPU, each
joined to a gloo process group through a file store (no TCP port), and
returns each rank's result.  This module imports ``torch`` and
``repro_torch`` only, so a spawned child, which imports it to find its
worker, never imports JAX; the JAX references run in the parent.  No
process group is ever initialised in the pytest process.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint import store as ckpt
from repro_torch.core import resilience as rsl
from repro_torch.core import topology as tpo
from repro_torch.core import transport as tp
from repro_torch.launch import mesh as ms
from repro_torch.snn import network as net


def spawn(worker, world: int, tmp: Path, *args,
          backend: str = "gloo") -> list:
    """``worker(rank, world, *args)`` in ``world`` processes of a
    ``backend`` group (gloo on the CPU; nccl on the card, rank r on GPU
    r); its results (trees of tensors, numbers and strings), in rank
    order."""
    tag = f"{worker.__name__}-{world}"
    mp.spawn(_child, args=(worker, world, str(tmp / f"store-{tag}"),
                           str(tmp / f"out-{tag}"), args, backend),
             nprocs=world, join=True)
    return [torch.load(tmp / f"out-{tag}-{r}.pt", weights_only=False)
            for r in range(world)]


def _child(rank, worker, world, store, out, args, backend):
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method="file://" + store,
                            rank=rank, world_size=world)
    try:
        result = worker(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, f"{out}-{rank}.pt")


def _error(fn) -> str:
    """The type and message of what ``fn()`` raises ('' if nothing)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - reported to the parent
        return f"{type(e).__name__}: {e}"
    return ""


def _mesh(shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names)


# -- transports ---------------------------------------------------------------

def shifted(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x`` with ``k`` added to every valid (non-negative) word: pod k's
    own block in the exchanges over the chip axis of a 2 x 2 mesh."""
    return torch.where(x >= 0, x + k, x)


def transport_worker(rank: int, world: int, data: dict) -> dict:
    """Every transport case at ``world`` 4 (see tests/test_torch_
    transport.py): the flat exchange at one and two chips a rank, the
    hierarchical ones, put, psum, chip_index, the exchange protocol over
    the chip axis of a 2 x 2 mesh (two ranks of two chips), and the
    routed transports."""
    flat = ms.make_chip_mesh(device_type="cpu")
    pod = _mesh((2, 2), ("pod", "chip"))
    three = _mesh((2, 1, 2), ("a", "b", "c"))
    x4 = torch.as_tensor(data["x4"])
    x8 = torch.as_tensor(data["x8"])
    out = {}
    t4 = tp.DistributedTransport(mesh=flat, axis="chip", n_chips=4)
    mine = x4[t4.rows]
    out["a2a4"] = t4.all_to_all(mine)
    out["put4"] = t4.put(mine, data["perm"])
    out["psum4"] = t4.psum(mine)
    out["chip_index4"] = t4.chip_index()
    t8 = tp.DistributedTransport(mesh=flat, axis="chip", n_chips=8)
    out["a2a8"] = t8.all_to_all(x8[t8.rows])
    out["chip_index8"] = t8.chip_index()
    out["psum8"] = t8.psum(x8[t8.rows])
    for name, mesh, axis in (("pod", pod, ("pod", "chip")),
                             ("three", three, ("a", "b", "c"))):
        t = tp.DistributedTransport(mesh=mesh, axis=axis, n_chips=8)
        out[f"a2a8_{name}"] = t.all_to_all(x8[t.rows])
        out[f"chip_index8_{name}"] = t.chip_index()
        out[f"psum8_{name}"] = t.psum(x8[t.rows])
    # Two ranks of two chips: the chip axis of the 2 x 2 mesh, one
    # exchange per pod, pod p on the block x4 + 100 p.
    sub = tp.DistributedTransport(mesh=pod, axis="chip", n_chips=4)
    xp = shifted(x4, 100 * pod.get_local_rank("pod"))
    out["start_sub"] = sub.exchange_words_start(xp[sub.rows])
    out["put_sub"] = sub.put(xp[sub.rows], data["perm"])
    host = ms.make_host_mesh(2, device_type="cpu")
    out["meshes"] = dict(
        chip=(tuple(flat.shape), flat.mesh_dim_names),
        chip3=tuple(ms.make_chip_mesh(3, device_type="cpu").shape),
        host=(tuple(host.shape), host.mesh_dim_names),
        production=_error(lambda: ms.make_production_mesh(
            device_type="cpu")),
        too_big=_error(lambda: ms.make_chip_mesh(5, device_type="cpu")))
    out["errors"] = {
        "uneven": _error(lambda: tp.DistributedTransport(
            mesh=flat, axis="chip", n_chips=6)),
        "put_tuple": _error(lambda: tp.DistributedTransport(
            mesh=pod, axis=("pod", "chip"), n_chips=4).put(x4[:1], [])),
        "tree_tuple": _error(lambda: tpo.switch_tree(2, 2).transport(
            ("pod", "chip"), mesh=pod)),
    }
    routed = {}
    for key, (topo, healthy, dead_links, where, words) in data[
            "routed"].items():
        mesh, axis = dict(flat=(flat, "chip"), sub=(pod, "chip"),
                          pod2=(pod, ("pod", "chip")))[where]
        tr = topo.transport(axis, mesh=mesh).with_health(healthy, dead_links)
        x = torch.as_tensor(words)
        if where == "sub":
            x = shifted(x, pod.get_local_rank("pod"))
        y, lw, lb = tr.exchange_words_start(x[tr.rows])
        routed[key] = (tr.exchange_words_finish(y), lw, lb)
    out["routed"] = routed
    return out


# -- the shard forms ----------------------------------------------------------

def _record(rec) -> dict:
    return dict(spikes=rec.spikes, voltage=rec.voltage,
                stats={f: getattr(rec.stats, f) for f in rec.stats._fields})


def _final(state) -> dict:
    out = dict(ring=state.ring.ring, now=state.ring.now, t=state.t,
               v=state.neuron.v)
    if state.merge is not None:
        out["merge"] = state.merge.words
    if state.flow is not None:
        out.update({f"flow.{f}": v for f, v in zip(state.flow._fields,
                                                   state.flow)})
    if state.sendq is not None:
        out.update(sendq_words=state.sendq.words, sendq_dest=state.sendq.dest)
    return out


def drive_shard(case: dict, mesh, rank: int, n_local: int) -> dict:
    """One case of tests/test_torch_shard.py on this rank: the shard form
    it names over the run, records stacked along time (a pipelined run's
    stats realigned to their blocks), and the final state."""
    cfg, params = case["cfg"], case["params"]
    ext = torch.as_tensor(case["ext"])
    full = net.init_state(cfg, params, device="cpu")
    p = net.shard_slice(params, rank, n_local)
    state = net.shard_slice(full, rank, n_local)
    rows = slice(rank * n_local, (rank + 1) * n_local)
    b = cfg.comm.superstep
    recs, stats = [], []
    for t in range(0, ext.shape[0], b):
        e = ext[t:t + b, rows]
        if case["form"] == "step":
            state, rec = net.shard_step(cfg, "chip", p, state, e[0],
                                        mesh=mesh)
            rec = net.StepRecord(
                spikes=rec.spikes[None], voltage=rec.voltage[None],
                stats=type(rec.stats)(*(x[None] for x in rec.stats)))
        elif case["form"] == "pipeline":
            state, rec = net.shard_pipeline_block(cfg, "chip", p, state, e,
                                                  mesh=mesh)
        else:
            state, rec = net.shard_superstep(cfg, "chip", p, state, e,
                                             mesh=mesh)
        recs.append(rec)
        stats.append(rec.stats)
    if case["form"] == "pipeline":
        state, flushed = net.shard_flush_pending(cfg, "chip", state,
                                                 mesh=mesh)
        stats = stats[1:] + [flushed]
    rec = net.StepRecord(
        spikes=torch.cat([r.spikes for r in recs]),
        voltage=torch.cat([r.voltage for r in recs]),
        stats=type(stats[0])(*(torch.cat(x) for x in zip(*stats))))
    return dict(record=_record(rec), final=_final(state))


def shard_worker(rank: int, world: int, cases: dict, alive) -> dict:
    """Every case of tests/test_torch_shard.py at ``world`` (4 chips:
    one or two a rank), the heartbeat with one chip silent, and the
    guards that need a process group."""
    mesh = ms.make_chip_mesh(device_type="cpu")
    n_local = 4 // world
    out = {name: drive_shard(case, mesh, rank, n_local)
           for name, case in cases.items()}
    t = tp.DistributedTransport(mesh=mesh, axis="chip", n_chips=4)
    bits = torch.as_tensor(alive)[t.rows]
    out["heartbeat"] = rsl.heartbeat(t, bits)
    out["heartbeat_none"] = rsl.heartbeat(None, bits)
    any_case = next(iter(cases.values()))
    cfg = any_case["cfg"]
    wide = net.NetworkConfig(comm=type(cfg.comm)(
        **{**cfg.comm.__dict__, "n_chips": 5}))
    out["errors"] = {
        "uneven": _error(lambda: net.shard_fabric(wide, "chip", mesh=mesh)),
        "rows": _error(lambda: net.shard_superstep(
            cfg, "chip", any_case["params"],
            net.init_state(cfg, any_case["params"], device="cpu"),
            torch.zeros((cfg.comm.superstep, 4, cfg.comm.n_inputs_per_chip)),
            mesh=mesh)),
    }
    return out


# -- checkpoints --------------------------------------------------------------

def _placed(x) -> dict:
    return dict(local=x.to_local(), full=x.full_tensor(),
                placements=[repr(p) for p in x.placements],
                mesh=tuple(x.device_mesh.shape))


def checkpoint_worker(rank: int, world: int, src: str, dst: str) -> dict:
    """Restore the JAX-written checkpoint at ``src`` onto a ``world``-rank
    chip mesh (``w`` sharded, ``b`` replicated), then save the DTensors
    to ``dst`` and restore them again."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = ms.make_chip_mesh(device_type="cpu")
    shardings = {"w": (mesh, [Shard(0)]), "b": (mesh, [Replicate()])}
    target = {"w": torch.zeros(24, 4), "b": torch.zeros(8)}
    step = ckpt.latest_step(src)
    got = ckpt.restore(src, step, target, shardings=shardings)
    ckpt.save(got, dst, step)
    again = ckpt.restore(dst, step, target, shardings=shardings)
    return dict(step=step, got={k: _placed(v) for k, v in got.items()},
                again={k: _placed(v) for k, v in again.items()})


def resume_worker(rank: int, world: int, src: str) -> dict:
    """``TrainRunner.resume_or(..., shardings=)`` onto a ``world``-rank
    chip mesh from the JAX-written checkpoint at ``src``."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.runtime import TrainRunner

    mesh = ms.make_chip_mesh(device_type="cpu")
    shardings = {"w": (mesh, [Shard(0)]), "b": (mesh, [Replicate()])}
    runner = TrainRunner(step_fn=lambda s, t: s, ckpt_dir=src)
    target = {"w": torch.zeros(24, 4), "b": torch.zeros(8)}
    got, start = runner.resume_or(target, shardings=shardings)
    return dict(start=start, got={k: _placed(v) for k, v in got.items()})


# -- the card -----------------------------------------------------------------

def card_shard_worker(rank: int, world: int) -> dict:
    """``shard_superstep`` over NCCL (8 chips x 64 LIF, fan-out 1, full,
    merge_rate 8, B 4, T 16) on GPU ``rank`` against the local run on
    the same card: whether spikes, voltages, every integer stat, ring and
    merge queue of this rank's rows are equal, and the shard run's kernel
    launches."""
    from repro_torch.core import pulse_comm as pc
    from repro_torch.core import routing as rt
    from repro_torch.kernels import common as kc

    device = torch.device("cuda", rank)
    comm = pc.PulseCommConfig(n_chips=8, neurons_per_chip=64,
                              n_inputs_per_chip=64, event_capacity=64,
                              bucket_capacity=8, buckets_per_chip=2,
                              mode="full", merge_rate=8, ring_depth=20,
                              superstep=4)
    cfg = net.NetworkConfig(comm=comm)
    gen = torch.Generator().manual_seed(0)
    table = rt.random_table(gen, 64, 8, min_delay=6, max_delay=12)
    params = net.init_params(gen, cfg, table=table, device=device)
    ext = ((torch.rand((16, 8, 64), generator=gen) < 0.1).float() * 2
           ).to(device)
    final, rec = net.run(cfg, params, net.init_state(cfg, params,
                                                     device=device),
                         ext, device=device)
    mesh = ms.make_chip_mesh()
    n_local = 8 // world
    rows = slice(rank * n_local, (rank + 1) * n_local)
    p = net.shard_slice(params, rank, n_local)
    state = net.shard_slice(net.init_state(cfg, params, device=device),
                            rank, n_local)
    kc.reset_launches()
    recs = []
    for t in range(0, 16, 4):
        state, r = net.shard_superstep(cfg, "chip", p, state,
                                       ext[t:t + 4, rows], mesh=mesh)
        recs.append(r)
    launches = dict(kc.launches)
    got = lambda f: torch.cat([getattr(r, f) for r in recs])  # noqa: E731
    equal = {"spikes": torch.equal(got("spikes"), rec.spikes[:, rows]),
             "voltage": torch.equal(got("voltage"), rec.voltage[:, rows]),
             "ring": torch.equal(state.ring.ring, final.ring.ring[rows]),
             "merge": torch.equal(state.merge.words,
                                  final.merge.words[rows])}
    for f in rec.stats._fields:
        if f != "utilization":
            equal[f] = torch.equal(
                torch.cat([getattr(r.stats, f) for r in recs]),
                getattr(rec.stats, f)[:, rows])
    return dict(equal=equal, launches=launches,
                sent=int(rec.stats.sent.sum()))


# -- the LM's sharding rules and the compressed-gradient trainer --------------

SHARD_MESHES = {
    2: {"host": ((2, 1), ("data", "model")),
        "model": ((1, 2), ("data", "model"))},
    4: {"host": ((2, 2), ("data", "model")),
        "pod": ((2, 2, 1), ("pod", "data", "model")),
        "kv": ((1, 2, 2), ("data", "kv", "mp"))},
}


def sharding_worker(rank: int, world: int, cases: dict) -> dict:
    """Each case ``(mesh name, logical axes, full tensor)`` of
    tests/test_torch_sharding.py at ``world``: the placements
    ``from_mesh(mesh).sharding`` gives, this rank's shard of the tensor
    distributed with them, and ``shard`` on a replicated DTensor (its
    placements, local shard and full tensor) and on a plain tensor."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.models import sharding as shd

    meshes = {name: _mesh(*m) for name, m in SHARD_MESHES[world].items()}
    out = {}
    for key, (mesh_name, axes, x) in cases.items():
        mesh = meshes[mesh_name]
        rules = shd.from_mesh(mesh)
        pl = rules.sharding(axes, tuple(x.shape))
        rep = distribute_tensor(x, mesh, [Replicate()] * mesh.ndim)
        moved = shd.shard(rep, rules, *axes)
        out[key] = dict(
            placements=[repr(p) for p in pl],
            local=distribute_tensor(x, mesh, list(pl)).to_local(),
            shard_placements=[repr(p) for p in moved.placements],
            shard_local=moved.to_local(), shard_full=moved.full_tensor(),
            plain_is_x=shd.shard(x, rules, *axes) is x,
            rank_error=_error(lambda: shd.shard(rep, rules, *axes[1:])))
    return out


def _psum_case(mesh, grads, res, noise, frac) -> dict:
    """``compressed_psum`` over the mesh's ``"data"`` group for each
    method, from this rank's gradients and residuals with a generator
    seeded alike on every rank; beside it the rank's own wires and
    residuals from ``compress_leaf`` and the noise its generator draws.
    With ``noise`` each leaf's int8 noise is the one given instead (the
    reference's, for a bitwise comparison)."""
    from repro_torch.optim import compression as cmp

    given, leaf = {}, cmp.compress_leaf

    def with_given(g, r, gen, *, method, topk_frac=0.01):
        if method != "int8":
            return leaf(g, r, gen, method=method, topk_frac=topk_frac)
        return cmp._compress(g, r, next(given["it"]), method=method,
                             topk_frac=topk_frac)

    if noise is not None:
        cmp.compress_leaf = with_given
    out = {}
    try:
        for method in ("none", "int8", "topk"):
            given["it"] = iter(noise or ())
            gen = torch.Generator().manual_seed(7)
            reduced, ef = cmp.compressed_psum(
                grads, cmp.EFState(residual=res), gen, mesh, method=method,
                topk_frac=frac)
            given["it"] = iter(noise or ())
            gen = torch.Generator().manual_seed(7)
            own = {k: cmp.compress_leaf(grads[k], res[k], gen,
                                        method=method, topk_frac=frac)
                   for k in sorted(grads)}
            out[method] = dict(
                reduced=reduced, residual=ef.residual,
                wire={k: w for k, (w, _) in own.items()},
                own_residual={k: r for k, (_, r) in own.items()})
    finally:
        cmp.compress_leaf = leaf
    gen = torch.Generator().manual_seed(7)
    out["noise"] = [torch.rand(g.shape, generator=gen) - 0.5
                    for g in (grads[k] for k in sorted(grads))]
    return out


def compress_worker(rank: int, world: int, data: dict) -> dict:
    """The cases of tests/test_torch_compression.py at ``world``: each
    ``compressed_psum`` case on its mesh (``(shape, names)``; a data group
    of one rank where "data" has size 1), the rank taking the gradients
    and residuals of its data coordinate; and, with ``data["steps"]``,
    :func:`compressed_steps` on the host mesh."""
    out = {}
    for name, case in data["psum"].items():
        mesh = _mesh(*case["mesh"])
        i = mesh.get_local_rank("data")
        out[name] = _psum_case(mesh, case["grads"][i], case["residual"][i],
                               case.get("noise"), case["frac"])
    if "steps" in data:
        out["steps"] = compressed_steps(world, data["steps"])
    return out


def compressed_steps(world: int, data: dict) -> list:
    """Two steps of ``make_compressed_step(method="none")`` on the
    ``"data"`` group of a (world, 1) host mesh, each rank on its rows of
    the batch: from ``data["states"][i]`` (the reference's state before
    step i, with zero residuals) on ``data["batches"][i]``.  Returns each
    step's new state and metrics."""
    from repro_torch.launch import mesh as lms
    from repro_torch.launch import train
    from repro_torch.optim import compression as cmp

    mesh = lms.make_host_mesh(device_type="cpu")
    step = train.make_compressed_step(data["cfg"], mesh, method="none",
                                      **data["kw"])
    out = []
    rank = mesh.get_local_rank("data")
    for state, batch in zip(data["states"], data["batches"]):
        n = batch["tokens"].shape[0] // world
        mine = {k: torch.as_tensor(v[rank * n:(rank + 1) * n])
                for k, v in batch.items()}
        state = dict(state, ef=cmp.ef_init(state["params"]))
        new, metrics = step(state, mine, torch.Generator().manual_seed(0))
        out.append(dict(state=new, metrics=metrics))
    return out
