"""The plain reference of the harness tests' stand-in second model: the
edge-regret GAT at other widths (embed 32, FFN 64, 4 heads), with weights
drawn from a seed in place of a checkpoint.  Its forward is the GAT
reference's; what is its own is the weights and their shapes.  It imports
nothing of the program."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference import regret_gat


def depth(model: dict) -> int:
    return model["n_heads"] if model.get("depth_from_heads", True) else model["n_layers"]


def shapes(model: dict) -> Dict[str, tuple]:
    """Every leaf's shape under the checkpoint's flat keys."""
    E, Hd, H, out = model["embed_dim"], model["hidden_dim"], model["n_heads"], model["out_dim"]
    leaves = {"params::embed/w": (model["in_dim"], E), "params::embed/b": (E,)}
    for i in range(depth(model)):
        p = f"params::layers/{i}/"
        leaves.update({p + "gat/fc_w": (E, E), p + "gat/attn_l": (H, E // H),
                       p + "gat/attn_r": (H, E // H), p + "bn1/scale": (E,), p + "bn1/bias": (E,),
                       p + "ffn1/w": (E, Hd), p + "ffn1/b": (Hd,), p + "ffn2/w": (Hd, E),
                       p + "ffn2/b": (E,), p + "bn2/scale": (E,), p + "bn2/bias": (E,)})
    leaves.update({"params::decision/w": (E, out), "params::decision/b": (out,)})
    for i in range(depth(model)):
        for bn in ("bn1", "bn2"):
            for stat in ("mean", "var"):
                leaves[f"bn_state::layers/{i}/{bn}/{stat}"] = (E,)
    return leaves


def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights drawn from `seed` on `device`, in one draw: every leaf
    uniform in +-1/sqrt(its first dimension), BatchNorm at scale 1, bias 0,
    mean 0, var 1."""
    leaves = shapes(model)
    sizes = [int(np.prod(s)) for s in leaves.values()]
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=g, device=device) * 2 - 1
    out = {}
    for (key, shape), part in zip(leaves.items(), torch.split(flat, sizes)):
        if key.endswith(("/scale", "/var")) and "/bn" in key:
            out[key] = torch.ones(shape, device=device)
        elif key.endswith(("/bias", "/mean")) and "/bn" in key:
            out[key] = torch.zeros(shape, device=device)
        else:
            out[key] = part.reshape(shape) / shape[0] ** 0.5
    return out


def predict(weights, coords: np.ndarray, scalers: dict, model: dict, *, prec: str, device,
            batch: int = 1) -> np.ndarray:
    """Regret predictions (B, E), float32, for (B, n, 2) coordinates."""
    return regret_gat.predict(weights, coords, scalers, n_heads=model["n_heads"],
                              depth=depth(model), prec=prec, device=device, batch=batch)
