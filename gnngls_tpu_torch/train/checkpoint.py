"""Reader for gnngls_tpu's npz checkpoints (load side only).

Keys are `params::<path>`, `bn_state::<path>` and a JSON `__meta__`, as
gnngls_tpu/train/checkpoint.py writes them; `opt_state::` entries are
ignored, since the port does not train yet.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np


def load_checkpoint(path) -> Tuple[Dict[str, np.ndarray], dict]:
    """Return the flat `params::`/`bn_state::` arrays and the metadata."""
    with np.load(path, allow_pickle=False) as z:
        blobs = {k: z[k] for k in z.files
                 if k.startswith(("params::", "bn_state::")) or k == "__meta__"}
    meta = json.loads(bytes(blobs.pop("__meta__").tobytes()).decode())
    return blobs, meta
