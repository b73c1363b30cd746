"""npz weight files.

A copy of `load_params_npz` from `relativepose_tpu/utils/checkpoint.py`
(numpy only): one compressed npz per parameter tree, '/'-joined keys, the
format of the shipped `relativepose_tpu/data/pretrained/*.npz` files.
`models/convert.py` turns the tree into the port's SCNet state_dict.
"""

from __future__ import annotations

import numpy as np


def load_params_npz(path: str, dtype=np.float32):
    """An npz weight file -> nested dict of numpy arrays (floats as
    `dtype`)."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            arr = z[key]
            if np.issubdtype(arr.dtype, np.floating):
                arr = arr.astype(dtype)
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
    return out
