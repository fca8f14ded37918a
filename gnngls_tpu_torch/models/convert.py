"""Weights from gnngls_tpu's flat npz key layout into `RegretGNN`.

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

_LAYER_KEY = re.compile(r"^(params|bn_state)::layers/(\d+)/(.+)$")


def port_name(key: str) -> str:
    """The `RegretGNN` state-dict name of a flat `params::`/`bn_state::` key."""
    m = _LAYER_KEY.match(key)
    if m:
        _, i, rest = m.groups()
        return f"layers.{i}.{rest.replace('/', '.')}"
    if key.startswith("params::"):
        return key[len("params::"):].replace("/", ".")
    raise KeyError(f"unexpected checkpoint key {key!r}")


def state_from_jax_numpy(blobs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat `params::`/`bn_state::` arrays -> a `RegretGNN` state dict."""
    return {port_name(key): torch.from_numpy(np.array(arr, dtype=np.float32))
            for key, arr in blobs.items()
            if not (key.startswith("opt_state::") or key == "__meta__")}


def load_model(path, cfg, device="cpu"):
    """A `RegretGNN` with the weights of a gnngls_tpu npz checkpoint."""
    from ..train.checkpoint import load_checkpoint
    from .regret_gat import RegretGNN

    blobs, _ = load_checkpoint(path)
    model = RegretGNN(cfg)
    model.load_state_dict(state_from_jax_numpy(blobs), strict=True)
    return model.to(device)
