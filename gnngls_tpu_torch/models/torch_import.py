"""Reference PyTorch checkpoints in and out of the port's `RegretGNN`
(gnngls_tpu/models/torch_import.py).

The reference saves `{epoch, model_state_dict, optimizer_state_dict, loss,
val_loss}` (scripts/train.py) with an `EdgePropertyPredictionModel` state
dict (gnngls/models.py; DGL GATConv's `fc.weight`, `attn_l`, `attn_r`).
Each reference name maps to a key of gnngls_tpu's npz layout, which
`models/convert.py` maps onto the port's module:

  embed_layer.{weight,bias}                                -> params::embed/{w,b} (w^T)
  message_passing_layers.{i}.message_passing.module.fc.weight
                                                           -> params::layers/{i}/gat/fc_w (^T)
  message_passing_layers.{i}.message_passing.module.attn_{l,r} (1, H, F)
                                                           -> params::layers/{i}/gat/attn_{l,r} (H, F)
  message_passing_layers.{i}.feed_forward.{0,2}.{weight,bias}
                                                           -> params::layers/{i}/bn{1,2}/{scale,bias}
  message_passing_layers.{i}.feed_forward.{0,2}.running_{mean,var}
                                                           -> bn_state::layers/{i}/bn{1,2}/{mean,var}
  message_passing_layers.{i}.feed_forward.1.module.{0,2}.{weight,bias}
                                                           -> params::layers/{i}/ffn{1,2}/{w,b} (w^T)
  decision_layer.{weight,bias}                             -> params::decision/{w,b} (w^T)

Torch Linear weights are (out, in); the port keeps (in, out).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from .convert import port_name, state_from_jax_numpy


def _linear(ref: str, key: str) -> List[Tuple[str, str, str]]:
    return [(f"{ref}.weight", f"{key}/w", "T"), (f"{ref}.bias", f"{key}/b", "")]


def key_map(depth: int) -> List[Tuple[str, str, str]]:
    """(reference name, gnngls_tpu key, how) for a model of `depth` layers;
    how is "T" (transpose), "head" (drop the leading axis) or ""."""
    out = _linear("embed_layer", "params::embed") + _linear("decision_layer", "params::decision")
    for i in range(depth):
        mp, lk = f"message_passing_layers.{i}", f"layers/{i}"
        gat = f"{mp}.message_passing.module"
        out += [(f"{gat}.fc.weight", f"params::{lk}/gat/fc_w", "T"),
                (f"{gat}.attn_l", f"params::{lk}/gat/attn_l", "head"),
                (f"{gat}.attn_r", f"params::{lk}/gat/attn_r", "head")]
        for ff, bn in (("0", "bn1"), ("2", "bn2")):
            out += [(f"{mp}.feed_forward.{ff}.weight", f"params::{lk}/{bn}/scale", ""),
                    (f"{mp}.feed_forward.{ff}.bias", f"params::{lk}/{bn}/bias", ""),
                    (f"{mp}.feed_forward.{ff}.running_mean", f"bn_state::{lk}/{bn}/mean", ""),
                    (f"{mp}.feed_forward.{ff}.running_var", f"bn_state::{lk}/{bn}/var", "")]
        out += (_linear(f"{mp}.feed_forward.1.module.0", f"params::{lk}/ffn1")
                + _linear(f"{mp}.feed_forward.1.module.2", f"params::{lk}/ffn2"))
    return out


def _depth(sd: Dict) -> int:
    i = 0
    while f"message_passing_layers.{i}.message_passing.module.fc.weight" in sd:
        i += 1
    return i


def model_from_state_dict(sd: Dict, cfg, device=None):
    """A `RegretGNN` with the weights of a reference model state dict, on
    `device`: "cuda" unless the caller asks for "cpu" (`core.device.resolve_device`)."""
    from .regret_gat import RegretGNN

    device = resolve_device(device)
    depth = _depth(sd)
    if depth != cfg.depth:
        raise ValueError(f"checkpoint has {depth} layers, config expects {cfg.depth} "
                         f"(n_heads={cfg.n_heads}, depth_from_heads={cfg.depth_from_heads})")
    blobs = {}
    for ref, key, how in key_map(depth):
        a = torch.as_tensor(sd[ref]).detach().cpu().numpy().astype(np.float32)
        blobs[key] = a.T if how == "T" else a[0] if how == "head" else a
    model = RegretGNN(cfg)
    model.load_state_dict(state_from_jax_numpy(blobs), strict=True)
    return model.to(device)


def load_checkpoint(path, cfg, device=None):
    """(model, meta) from a reference .pt file: a `{model_state_dict, ...}`
    checkpoint or a bare state dict; meta holds its epoch and losses.  The
    model is on `device`, as `model_from_state_dict` resolves it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    meta = {k: ckpt[k] for k in ("epoch", "loss", "val_loss") if k in ckpt}
    return model_from_state_dict(sd, cfg, device), meta


def state_dict_from_params(model) -> Dict[str, torch.Tensor]:
    """The model's weights as a reference-format state dict (CPU tensors)."""
    mine = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    sd = {}
    for ref, key, how in key_map(model.cfg.depth):
        t = mine[port_name(key)]
        sd[ref] = t.T.contiguous() if how == "T" else t[None].clone() if how == "head" \
            else t.clone()
    for i in range(model.cfg.depth):
        for ff in ("0", "2"):
            sd[f"message_passing_layers.{i}.feed_forward.{ff}.num_batches_tracked"] = \
                torch.tensor(0)
    return sd
