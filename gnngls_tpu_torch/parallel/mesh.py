"""Device meshes over torch.distributed (gnngls_tpu/parallel/mesh.py).

One rank is one device: a card under NCCL, or a CPU process under gloo.
Named axes as in the JAX package:
  * "data": instances (training batches, GLS populations);
  * "model": cities of the line graph's message passing (ops/gat_sharded.py,
    ops/gat_ring.py) and the FFN's hidden units (ops/tp.py).
The process group is set up by `parallel.multihost.initialize` or by the
caller, never here.  A sharded tensor is this rank's slice of the global
one: `data_sharding` cuts the leading axis, `replicated` keeps it whole.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def device_type() -> str:
    """The device of this process group's ranks: "cuda" under NCCL, else "cpu"."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def balanced_model_size(n: int) -> int:
    """The largest power of two m with n % m == 0 and m * m <= n."""
    model = 1
    while n % (model * 2) == 0 and (model * 2) ** 2 <= n:
        model *= 2
    return model


def make_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = ("data",),
              model_axis_size: Optional[int] = None) -> DeviceMesh:
    """A mesh over every rank of the initialised process group.

    For two axes the second gets `model_axis_size` ranks (by default
    `balanced_model_size` of the world) and the first the rest.
    n_devices, when given, must equal the world size: a rank cannot leave
    the group's collectives.  Host-aware layouts: multihost.make_host_mesh."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.multihost.initialize, or init_process_group)")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices} but the process group has {n} ranks")
    if len(axes) == 1:
        shape = (n,)
    elif len(axes) == 2:
        model = balanced_model_size(n) if model_axis_size is None else model_axis_size
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        shape = (n // model, model)
    else:
        raise ValueError("1 or 2 mesh axes supported")
    return init_device_mesh(device_type(), shape, mesh_dim_names=tuple(axes))


def data_sharding(mesh: DeviceMesh, x):
    """This rank's contiguous share of x's leading axis over "data"."""
    size = mesh["data"].size()
    if x.shape[0] % size != 0:
        raise ValueError(f"leading axis {x.shape[0]} not divisible by {size} 'data' ranks")
    per = x.shape[0] // size
    i = mesh.get_local_rank("data")
    return x[i * per:(i + 1) * per]


def replicated(mesh: DeviceMesh, x):
    """x kept whole on every rank (the counterpart of a replicated sharding)."""
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' equal-shaped tensors, concatenated along `dim` in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)
