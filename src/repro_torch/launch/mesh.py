"""Device meshes over the ranks of a ``torch.distributed`` process group
(port of ``repro.launch.mesh``).

Defined as FUNCTIONS, never module-level constants, so importing this
module touches no device and no process group.  Each builds a
:class:`torch.distributed.device_mesh.DeviceMesh` over the first ranks of
the initialised default group (``dist.init_process_group`` first), with
the reference's axis names: ``("chip",)`` for the SNN shard forms,
``("data", "model")`` on a host, ``("pod", "data", "model")`` (or the
kv-factored ``("data", "kv", "mp")`` forms) in production.  A mesh larger
than the world raises ``RuntimeError``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group "
            "(nccl on GPUs, gloo on the CPU) before building a mesh")
    return dist.get_world_size()


def _mesh(device_type: str, shape: tuple[int, ...],
          names: tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    n, world = math.prod(shape), _world()
    if n > world:
        raise RuntimeError(f"need {n} ranks for a mesh of shape {shape}, "
                           f"the process group has {world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, kv_factored: int = 0,
                         device_type: str = "cuda"):
    """kv_factored=K splits the 16-way tensor tier into ("kv", "mp") =
    (K, 16//K) so GQA caches shard K ways."""
    if kv_factored:
        mp = 16 // kv_factored
        shape = ((2, 16, kv_factored, mp) if multi_pod
                 else (16, kv_factored, mp))
        axes = (("pod", "data", "kv", "mp") if multi_pod
                else ("data", "kv", "mp"))
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_host_mesh(model_parallel: int = 1, *, device_type: str = "cuda"):
    """A ``("data", "model")`` mesh over whatever ranks exist."""
    n = _world()
    mp = max(1, min(model_parallel, n))
    return _mesh(device_type, (n // mp, mp), ("data", "model"))


def make_chip_mesh(n_chips: int | None = None, *,
                   device_type: str = "cuda"):
    """1-D ``("chip",)`` mesh for the SNN shard forms, over the first
    ``n_chips`` ranks (all of them by default).  A rank holds a block of
    chips; see :class:`repro_torch.core.transport.DistributedTransport`."""
    return _mesh(device_type, (n_chips or _world(),), ("chip",))
