"""Weights between gnngls_tpu's flat npz key layout and `RegretGNN`, both ways.

Keys (as gnngls_tpu/train/checkpoint.py flattens the JAX pytrees):
  params::embed/{w,b}, params::decision/{w,b},
  params::layers/{i}/gat/{fc_w,attn_l,attn_r},
  params::layers/{i}/bn{1,2}/{scale,bias}, params::layers/{i}/ffn{1,2}/{w,b},
  bn_state::layers/{i}/bn{1,2}/{mean,var}.
Both packages keep (C_in, C_out) weights, so no array is transposed.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..core.device import resolve_device

_LAYER_KEY = re.compile(r"^(params|bn_state)::layers/(\d+)/(.+)$")
_BN_STATE_NAME = re.compile(r"^layers\.\d+\.bn[12]\.(mean|var)$")


def port_name(key: str) -> str:
    """The `RegretGNN` state-dict name of a flat `params::`/`bn_state::` key."""
    m = _LAYER_KEY.match(key)
    if m:
        _, i, rest = m.groups()
        return f"layers.{i}.{rest.replace('/', '.')}"
    if key.startswith("params::"):
        return key[len("params::"):].replace("/", ".")
    raise KeyError(f"unexpected checkpoint key {key!r}")


def jax_key(name: str) -> str:
    """The flat `params::`/`bn_state::` key of a `RegretGNN` state-dict name
    (the inverse of `port_name`)."""
    tree = "bn_state" if _BN_STATE_NAME.match(name) else "params"
    return f"{tree}::{name.replace('.', '/')}"


def jax_numpy_from_state(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A `RegretGNN` state dict -> flat f32 arrays under gnngls_tpu's keys,
    the `params::` entries first, in the order gnngls_tpu flattens them."""
    flat = {jax_key(name): t.detach().cpu().numpy().astype(np.float32)
            for name, t in state.items()}
    return dict(sorted(flat.items(), key=lambda kv: kv[0].startswith("bn_state::")))


def state_from_jax_numpy(blobs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat `params::`/`bn_state::` arrays -> a `RegretGNN` state dict."""
    return {port_name(key): torch.from_numpy(np.array(arr, dtype=np.float32))
            for key, arr in blobs.items()
            if not (key.startswith("opt_state::") or key == "__meta__")}


def load_model(path, cfg, device=None):
    """A `RegretGNN` with the weights of a gnngls_tpu npz checkpoint, on
    `device`: "cuda" unless the caller asks for "cpu" (`core.device.resolve_device`)."""
    from ..train.checkpoint import load_checkpoint
    from .regret_gat import RegretGNN

    device = resolve_device(device)
    blobs, _ = load_checkpoint(path)
    model = RegretGNN(cfg)
    model.load_state_dict(state_from_jax_numpy(blobs), strict=True)
    return model.to(device)
