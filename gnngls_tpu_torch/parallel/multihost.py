"""Process bring-up and host-aware meshes (gnngls_tpu/parallel/multihost.py).

One rank per device: a JAX process owns every chip of its host, a torch rank
owns one card.  So here "host-local" means this rank's: `host_local_batch_slice`
is this rank's share, and `global_array_from_host_shards` assembles the ranks'
shards into one DTensor.  `make_host_mesh` keeps each "model" group inside
one node (LOCAL_WORLD_SIZE ranks), where its all_gathers ride NVLink.

A multi-process launch is recognised by the launchers' own signals:
torchrun's WORLD_SIZE > 1 with MASTER_ADDR, or Slurm's SLURM_STEP_NODELIST.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .mesh import device_type


def _launch_signal() -> bool:
    torchrun = int(os.environ.get("WORLD_SIZE", "1")) > 1 and bool(os.environ.get("MASTER_ADDR"))
    return torchrun or bool(os.environ.get("SLURM_STEP_NODELIST"))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Set up the default process group: NCCL with a card, gloo without.

    Idempotent, and a no-op in a single process with neither arguments nor
    a launcher's signal.  coordinator_address "host:port" gives a
    tcp:// rendezvous; otherwise the launcher's environment (env://: torchrun
    sets RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT; under Slurm the rank
    and size come from SLURM_PROCID and SLURM_NTASKS, the address from
    MASTER_ADDR and MASTER_PORT).  Under NCCL the rank's card is
    LOCAL_RANK (or SLURM_LOCALID)."""
    if dist.is_initialized():
        return
    explicit = coordinator_address is not None or num_processes is not None
    if not explicit and not _launch_signal():
        return
    rank = process_id
    world = num_processes
    if rank is None and "RANK" not in os.environ and "SLURM_PROCID" in os.environ:
        rank = int(os.environ["SLURM_PROCID"])
        world = int(os.environ["SLURM_NTASKS"]) if world is None else world
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK", os.environ.get("SLURM_LOCALID", "0"))
        torch.cuda.set_device(int(local))
    init = f"tcp://{coordinator_address}" if coordinator_address is not None else "env://"
    kw = {} if rank is None else {"rank": rank}
    if world is not None:
        kw["world_size"] = world
    dist.init_process_group(backend, init_method=init, **kw)


def _world() -> Tuple[int, int]:
    """(world size, rank); (1, 0) without a process group."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def host_mesh_shape(n: int, per_host: int, model_axis_size: int) -> Tuple[int, int]:
    """(data, model) for n ranks, per_host of them on each node, so that no
    model group straddles nodes unevenly; raises ValueError otherwise."""
    if n % model_axis_size != 0:
        raise ValueError(f"{n} devices not divisible by model={model_axis_size}")
    if n % per_host != 0:
        raise ValueError(f"{n} ranks do not fill nodes of {per_host}")
    if not (per_host % model_axis_size == 0 or
            (model_axis_size > per_host and model_axis_size % per_host == 0)):
        raise ValueError(f"model axis {model_axis_size} would straddle hosts unevenly "
                         f"({per_host} devices/host)")
    return n // model_axis_size, model_axis_size


def make_host_mesh(model_axis_size: int = 1,
                   axes: Sequence[str] = ("data", "model")) -> DeviceMesh:
    """A (data, model) mesh over every rank, rank-major as launchers number
    ranks node by node, so that a model group of ranks never straddles
    nodes unevenly (the node size is LOCAL_WORLD_SIZE, else the world)."""
    n, _ = _world()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    shape = host_mesh_shape(n, per_host, model_axis_size)
    return init_device_mesh(device_type(), shape, mesh_dim_names=tuple(axes))


def host_local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """[start, stop) of this rank's share of a batch split over all ranks."""
    n, i = _world()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    per = global_batch // n
    return i * per, (i + 1) * per


def global_array_from_host_shards(mesh: DeviceMesh, host_local: torch.Tensor):
    """A DTensor whose dim 0 is the ranks' shards in rank order (sharded over
    every axis of the mesh): `full_tensor()` concatenates them."""
    from torch.distributed.tensor import DTensor, Shard

    local = torch.as_tensor(host_local, device=mesh.device_type)
    return DTensor.from_local(local, mesh, [Shard(0)] * mesh.ndim)
