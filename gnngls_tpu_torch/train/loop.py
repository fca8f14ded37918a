"""Training loop: epochs, early stopping, checkpoints, metrics
(gnngls_tpu/train/loop.py, the reference's scripts/train.py).

  * shuffled mini-batches of the scaled features and targets, the order
    from numpy's default_rng(seed), so that both packages see the same
    batches;
  * Adam(lr_init), lr *= lr_decay each epoch (ExponentialLR);
  * early stopping on the monitored loss with min_delta and patience.  The
    reference monitors an eval pass over the TRAIN set (`val_on_train=True`,
    the default); `val_on_train=False` monitors the val set.  The monitored
    pass takes its batches from default_rng(0);
  * checkpoints checkpoint_best_val, checkpoint_{epoch} every
    checkpoint_freq epochs and checkpoint_final, plus params.json;
  * one metrics.jsonl row an epoch.
The model lives on `device` (cuda unless "cpu" is asked for); each batch is
copied there.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Optional

import numpy as np
import torch

from ..data.dataset import TSPDataset
from ..core.device import resolve_device
from ..models import regret_gat as M
from . import checkpoint as ckpt
from .step import eval_step, make_optimizer, set_lr, train_step


@dataclasses.dataclass
class TrainConfig:
    embed_dim: int = 128
    n_layers: int = 3
    n_heads: int = 8
    lr_init: float = 1e-3
    lr_decay: float = 0.99
    min_delta: float = 1e-4
    patience: int = 20
    batch_size: int = 32
    n_epochs: int = 100
    checkpoint_freq: Optional[int] = None
    target: str = "regret"  # or 'in_solution'
    seed: int = 0
    val_on_train: bool = True  # reference quirk, train.py:137
    bug_compat_bce_target: bool = True  # the reference's in_solution holds regret
    depth_from_heads: bool = True  # reference quirk: depth = n_heads
    gat_impl: str = "fast"  # a route of models.regret_gat.TRAIN_ROUTES, f32 or bf16
    # Bouts: stop after this many epochs in this call, save checkpoint_{epoch}
    # and return without checkpoint_final; the caller resumes from it.
    max_epochs_per_call: Optional[int] = None

    def to_params_json(self) -> dict:
        """The run's params.json (the reference writes its flags there)."""
        return dataclasses.asdict(self)


def _batches(N, batch_size, rng):
    idx = rng.permutation(N)
    for s in range(0, N, batch_size):
        yield idx[s:s + batch_size]


def train_model(train_set: TSPDataset, val_set: TSPDataset, cfg: TrainConfig, run_dir, *,
                verbose: bool = True, resume_from=None, device=None, step_times=None):
    """Train the regret model; returns (model, history).

    resume_from: a checkpoint .npz (either package's): restores the weights,
    the BatchNorm statistics and Adam's state, and continues at the saved
    epoch + 1 with the learning rate advanced to it.  The patience counter
    and the best-val score start afresh, as in gnngls_tpu (so each bout of
    a bouted run tracks its own best).  step_times, when a list, receives
    the host clock after each train step, synchronised with the device."""
    dev = resolve_device(device)
    run_dir = pathlib.Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)

    model_cfg = M.RegretGNNConfig(
        in_dim=train_set.feat_dim, embed_dim=cfg.embed_dim, out_dim=1,
        n_layers=cfg.n_layers, n_heads=cfg.n_heads, depth_from_heads=cfg.depth_from_heads)
    model = M.init_params(model_cfg, torch.Generator().manual_seed(cfg.seed)).to(dev)
    optimizer = make_optimizer(model, cfg.lr_init)

    if cfg.target == "regret":
        target_key, pos_weight = "regret", 1.0
    else:
        # pos_weight = len(y)/y.sum() - 1 on the first instance (train.py:111-115)
        target_key = "regret_unscaled" if cfg.bug_compat_bce_target else "in_solution"
        y0 = train_set.get_scaled_batch([0])[target_key]
        pos_weight = float(y0.size / y0.sum() - 1.0)
    kw = dict(target_kind=cfg.target, pos_weight=pos_weight, gat_impl=cfg.gat_impl)

    with open(run_dir / "params.json", "w") as f:
        json.dump(cfg.to_params_json(), f, indent=2)

    rng = np.random.default_rng(cfg.seed)
    history = []
    best_score, counter = None, 0
    lr = cfg.lr_init
    start_epoch = 0
    if resume_from is not None:
        meta = ckpt.restore_checkpoint(resume_from, model, optimizer)
        start_epoch = int(meta.get("epoch", -1)) + 1
        lr = cfg.lr_init * cfg.lr_decay ** start_epoch
        if verbose:
            print(f"resumed from {resume_from} at epoch {start_epoch}")

    def tensors(ds, bidx):
        batch = ds.get_scaled_batch(bidx)
        return (torch.as_tensor(batch["features"], device=dev),
                torch.as_tensor(batch[target_key], device=dev))

    def save(name, epoch, loss, val_loss):
        ckpt.save_checkpoint(run_dir / name, model, optimizer, epoch=epoch, loss=loss,
                             val_loss=val_loss)

    monitored_set = train_set if cfg.val_on_train else val_set
    epoch = start_epoch
    with open(run_dir / "metrics.jsonl", "a") as metrics_f:
        for epoch in range(start_epoch, cfg.n_epochs):
            set_lr(optimizer, lr)
            t0 = time.time()
            losses = []
            for bidx in _batches(len(train_set), cfg.batch_size, rng):
                losses.append(float(train_step(model, optimizer, *tensors(train_set, bidx),
                                               **kw)))
                if step_times is not None:
                    step_times.append(time.time())
            epoch_loss = float(np.mean(losses))

            val_losses = [float(eval_step(model, *tensors(monitored_set, bidx), **kw))
                          for bidx in _batches(len(monitored_set), cfg.batch_size,
                                               np.random.default_rng(0))]
            epoch_val_loss = float(np.mean(val_losses))

            row = {"epoch": epoch, "loss": epoch_loss, "val_loss": epoch_val_loss,
                   "lr": lr, "time": time.time() - t0}
            history.append(row)
            metrics_f.write(json.dumps(row) + "\n")
            metrics_f.flush()
            if verbose:
                print(f"epoch {epoch}: train {epoch_loss:.6f} val {epoch_val_loss:.6f} "
                      f"lr {lr:.2e} ({row['time']:.1f}s)")

            if cfg.checkpoint_freq is not None and epoch > 0 \
                    and epoch % cfg.checkpoint_freq == 0:
                save(f"checkpoint_{epoch}.npz", epoch, epoch_loss, epoch_val_loss)

            if best_score is None or epoch_val_loss < best_score - cfg.min_delta:
                save("checkpoint_best_val.npz", epoch, epoch_loss, epoch_val_loss)
                best_score, counter = epoch_val_loss, 0
            else:
                counter += 1
            if counter >= cfg.patience:
                break

            lr *= cfg.lr_decay

            if (cfg.max_epochs_per_call is not None
                    and epoch - start_epoch + 1 >= cfg.max_epochs_per_call
                    and epoch < cfg.n_epochs - 1):
                save(f"checkpoint_{epoch}.npz", epoch, epoch_loss, epoch_val_loss)
                if verbose:
                    print(f"bout bound: stopping after epoch {epoch} "
                          f"(no final checkpoint — resume to continue)", flush=True)
                return model, history

    save("checkpoint_final.npz", epoch, history[-1]["loss"] if history else None,
         history[-1]["val_loss"] if history else None)
    return model, history
