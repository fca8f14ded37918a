"""Data-parallel training over the "data" axis of a mesh
(gnngls_tpu/parallel/train_dp.py).

Each rank holds the whole model and optimizer and takes its share of every
batch (`shard_batch`).  The steps are train/step.py's with the axis' process
group: BatchNorm over the global batch, the global mean loss, gradients
summed before Adam steps the replicated parameters, so the ranks compute
what one process computes on the whole batch, up to float summation order.
"""

from __future__ import annotations

import torch

from ..models.regret_gat import RegretGNN
from ..train import step
from .mesh import data_sharding


def make_dp_train_step(model: RegretGNN, optimizer: torch.optim.Optimizer, mesh, *,
                       target: str = "regret", pos_weight: float = 1.0,
                       gat_impl: str = "fast"):
    """(train_step, eval_step), each fn(x, y) -> the global loss, over this
    rank's share (x (B/ndev, E, in_dim), y (B/ndev, E, 1)).  The model
    carries its configuration and n follows from E, where gnngls_tpu's
    takes cfg and n."""
    group = mesh.get_group("data")
    kw = dict(target_kind=target, pos_weight=pos_weight, gat_impl=gat_impl, group=group)

    def train_step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return step.train_step(model, optimizer, x, y, **kw)

    def eval_step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return step.eval_step(model, x, y, **kw)

    return train_step, eval_step


def shard_batch(mesh, batch: dict, device=None) -> dict:
    """This rank's share of every array of a host batch, as tensors on
    `device` (by default the mesh's)."""
    device = mesh.device_type if device is None else device
    return {k: torch.as_tensor(data_sharding(mesh, v), device=device)
            for k, v in batch.items()}
