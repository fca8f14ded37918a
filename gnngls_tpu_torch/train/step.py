"""Train and eval steps and the optimizer (gnngls_tpu/train/step.py).

The reference trains with Adam(lr_init) and a per-epoch ExponentialLR
(lr_decay); the loss is MSE on the min-max-scaled regret (target 'regret'),
or BCEWithLogits with pos_weight on target 'in_solution'.  The optimizer is
torch.optim.Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root
0), its betas rounded to f32 as gnngls_tpu's optimizer state holds them
(1 - b2 then differs from 1e-3 by 1.3e-5 relative, as in optax); the loop
sets its learning rate once an epoch (`set_lr`).

Given a process group (data parallelism, parallel/train_dp.py), x and y are
this rank's share of the global batch and the steps compute what one
process computes on the whole batch, as the JAX package's sharded program
does: BatchNorm takes the global batch's statistics (`ops.norm.
batch_norm_group`), the loss is the global mean, and the gradients are
summed over the group before the step, so every rank steps the same
replicated parameters.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.regret_gat import RegretGNN
from ..ops.norm import batch_norm_group

B1, B2, EPS = float(np.float32(0.9)), float(np.float32(0.999)), 1e-8


def make_optimizer(model: RegretGNN, lr: float = 1e-3) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(B1, B2), eps=EPS)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The per-epoch learning rate (ExponentialLR's value for the epoch)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def bce_with_logits_loss(pred: torch.Tensor, target: torch.Tensor,
                         pos_weight: float) -> torch.Tensor:
    """torch's BCEWithLogitsLoss with pos_weight and mean reduction, in
    gnngls_tpu's expression order."""
    log_sig = F.logsigmoid(pred)
    log_sig_neg = F.logsigmoid(-pred)
    losses = -(pos_weight * target * log_sig + (1.0 - target) * log_sig_neg)
    return torch.mean(losses)


def loss_fn(pred: torch.Tensor, target: torch.Tensor, *, target_kind: str = "regret",
            pos_weight: float = 1.0) -> torch.Tensor:
    if target_kind == "regret":
        return mse_loss(pred, target)
    return bce_with_logits_loss(pred, target, pos_weight)


def _global_mean(loss: torch.Tensor, group) -> torch.Tensor:
    """The mean of the ranks' losses: the global batch's, as the shares are equal."""
    loss = loss.detach().clone()
    dist.all_reduce(loss, group=group)
    return loss / dist.get_world_size(group)


def train_step(model: RegretGNN, optimizer: torch.optim.Optimizer, x: torch.Tensor,
               y: torch.Tensor, *, target_kind: str = "regret", pos_weight: float = 1.0,
               gat_impl: str = "fast", group=None) -> torch.Tensor:
    """Forward in train mode (BatchNorm on batch statistics, running
    statistics updated), the loss, its gradient and one Adam step.  x
    (B, E, in_dim), y (B, E, 1); with `group`, this rank's share.  Returns
    the loss before the step."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    with batch_norm_group(model, group):
        loss = loss_fn(model(x, gat_impl=gat_impl), y, target_kind=target_kind,
                       pos_weight=pos_weight)
    if group is None:
        loss.backward()
    else:
        (loss / dist.get_world_size(group)).backward()
        for p in model.parameters():
            if p.grad is not None:
                dist.all_reduce(p.grad, group=group)
        loss = _global_mean(loss, group)
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def eval_step(model: RegretGNN, x: torch.Tensor, y: torch.Tensor, *,
              target_kind: str = "regret", pos_weight: float = 1.0,
              gat_impl: str = "fast", group=None) -> torch.Tensor:
    """The loss in eval mode (running statistics), without a gradient; with
    `group`, the global batch's."""
    model.eval()
    loss = loss_fn(model(x, gat_impl=gat_impl), y, target_kind=target_kind,
                   pos_weight=pos_weight)
    return loss if group is None else _global_mean(loss, group)
