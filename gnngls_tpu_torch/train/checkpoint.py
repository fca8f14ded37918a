"""npz checkpoints in gnngls_tpu's key layout (gnngls_tpu/train/checkpoint.py),
read and written, so that each package resumes the other's file.

Keys:
  params::<path>, bn_state::<path>        the model (models/convert.py)
  opt_state::count                         int32, Adam steps taken
  opt_state::hyperparams/{b1,b2,eps,eps_root,learning_rate}   f32 scalars
  opt_state::inner_state/0/count           int32, the same steps
  opt_state::inner_state/0/{mu,nu}/<path>  Adam's first and second moments
  __meta__                                 JSON {epoch, loss, val_loss} as uint8
optax's mu, nu and count are torch.optim.Adam's exp_avg, exp_avg_sq and
step, so the bias correction carries on across the packages.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.convert import jax_key, jax_numpy_from_state, state_from_jax_numpy

_INNER = "opt_state::inner_state/0"


def load_checkpoint(path) -> Tuple[Dict[str, np.ndarray], dict]:
    """Return the flat `params::`/`bn_state::` arrays and the metadata."""
    with np.load(path, allow_pickle=False) as z:
        blobs = {k: z[k] for k in z.files
                 if k.startswith(("params::", "bn_state::")) or k == "__meta__"}
    meta = json.loads(bytes(blobs.pop("__meta__").tobytes()).decode())
    return blobs, meta


def _param_paths(model: torch.nn.Module):
    """(gnngls_tpu path, parameter) in the optimizer's order."""
    return [(jax_key(name).split("::", 1)[1], p) for name, p in model.named_parameters()]


def _adam_blobs(model: torch.nn.Module, optimizer: torch.optim.Adam) -> Dict[str, np.ndarray]:
    group = optimizer.param_groups[0]
    paths = _param_paths(model)
    states = [optimizer.state.get(p, {}) for _, p in paths]
    steps = {int(st["step"]) for st in states if st}
    if len(steps) > 1:
        raise ValueError(f"parameters have taken different numbers of Adam steps: {steps}")
    count = np.int32(steps.pop() if steps else 0)

    def moment(st, p, key):
        return (st[key] if st else torch.zeros_like(p)).detach().cpu().numpy().astype(np.float32)

    b1, b2 = group["betas"]
    blobs = {"opt_state::count": count}
    for name, value in (("b1", b1), ("b2", b2), ("eps", group["eps"]), ("eps_root", 0.0),
                        ("learning_rate", group["lr"])):
        blobs[f"opt_state::hyperparams/{name}"] = np.float32(value)
    blobs[f"{_INNER}/count"] = count
    for opt_key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        for (path, p), st in zip(paths, states):
            blobs[f"{_INNER}/{opt_key}/{path}"] = moment(st, p, torch_key)
    return blobs


def save_checkpoint(path, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Adam] = None, *, epoch: int = 0,
                    loss=None, val_loss=None) -> None:
    """The model, the optimizer's state when given, and the metadata."""
    blobs = jax_numpy_from_state(model.state_dict())
    if optimizer is not None:
        blobs.update(_adam_blobs(model, optimizer))
    meta = {"epoch": int(epoch),
            "loss": None if loss is None else float(loss),
            "val_loss": None if val_loss is None else float(val_loss)}
    blobs["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **blobs)


def restore_checkpoint(path, model: torch.nn.Module,
                       optimizer: Optional[torch.optim.Adam] = None) -> dict:
    """Load the weights into `model` and, when the file has them and an
    optimizer is given, Adam's moments, step count and hyperparameters into
    `optimizer`.  Returns the metadata."""
    with np.load(path, allow_pickle=False) as z:
        blobs = {k: z[k] for k in z.files}
    meta = json.loads(bytes(blobs.pop("__meta__").tobytes()).decode())
    model.load_state_dict(state_from_jax_numpy(blobs), strict=True)
    if optimizer is None or "opt_state::count" not in blobs:
        return meta
    hyper = {k.rsplit("/", 1)[1]: float(v) for k, v in blobs.items()
             if k.startswith("opt_state::hyperparams/")}
    if hyper["eps_root"] != 0.0:
        raise ValueError(f"eps_root {hyper['eps_root']} != 0: torch.optim.Adam has none")
    step = torch.tensor(float(int(blobs[f"{_INNER}/count"])), dtype=torch.float32)
    state = optimizer.state_dict()
    state["state"] = {
        i: {"step": step.clone(),
            "exp_avg": torch.from_numpy(np.array(blobs[f"{_INNER}/mu/{path}"], np.float32)),
            "exp_avg_sq": torch.from_numpy(np.array(blobs[f"{_INNER}/nu/{path}"], np.float32))}
        for i, (path, _) in enumerate(_param_paths(model))}
    for group in state["param_groups"]:
        group.update(lr=hyper["learning_rate"], betas=(hyper["b1"], hyper["b2"]),
                     eps=hyper["eps"])
    optimizer.load_state_dict(state)
    return meta
