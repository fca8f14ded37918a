"""Train and eval steps and the optimizer (gnngls_tpu/train/step.py).

The reference trains with Adam(lr_init) and a per-epoch ExponentialLR
(lr_decay); the loss is MSE on the min-max-scaled regret (target 'regret'),
or BCEWithLogits with pos_weight on target 'in_solution'.  The optimizer is
torch.optim.Adam with optax's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root
0), its betas rounded to f32 as gnngls_tpu's optimizer state holds them
(1 - b2 then differs from 1e-3 by 1.3e-5 relative, as in optax); the loop
sets its learning rate once an epoch (`set_lr`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.regret_gat import RegretGNN

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


def train_step(model: RegretGNN, optimizer: torch.optim.Optimizer, x: torch.Tensor,
               y: torch.Tensor, *, target_kind: str = "regret", pos_weight: float = 1.0,
               gat_impl: str = "fast") -> torch.Tensor:
    """Forward in train mode (BatchNorm on batch statistics, running
    statistics updated), the loss, its gradient and one Adam step.  x
    (B, E, in_dim), y (B, E, 1).  Returns the loss before the step."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model(x, gat_impl=gat_impl), y, target_kind=target_kind,
                   pos_weight=pos_weight)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def eval_step(model: RegretGNN, x: torch.Tensor, y: torch.Tensor, *,
              target_kind: str = "regret", pos_weight: float = 1.0,
              gat_impl: str = "fast") -> torch.Tensor:
    """The loss in eval mode (running statistics), without a gradient."""
    model.eval()
    return loss_fn(model(x, gat_impl=gat_impl), y, target_kind=target_kind,
                   pos_weight=pos_weight)
