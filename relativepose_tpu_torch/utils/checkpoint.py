"""npz weight files and numbered training checkpoints.

`save_params_npz` / `load_params_npz` are the JAX package's npz format
(`relativepose_tpu/utils/checkpoint.py`): one compressed npz per parameter
tree, '/'-joined keys, floats in f16 by default, the format of the shipped
`relativepose_tpu/data/pretrained/*.npz` files.  Each package reads what
the other writes; `models/convert.py` maps the tree to and from the port's
modules.

`CheckpointManager` keeps the JAX package's numbered `checkpoint_%04d`,
keep-N and partial-restore semantics without orbax (which needs JAX):
each save writes `checkpoint_%04d.npz`, the trained networks' parameter
tree in the npz format above, and beside it `checkpoint_%04d.resume.npz`,
everything a resumed run needs in f32 (`train/state.py`).
"""

from __future__ import annotations

import os
import re

import numpy as np


def save_params_npz(path: str, params, dtype=np.float16) -> str:
    """Write a nested dict of arrays as one compressed npz with '/'-joined
    keys, floats cast to `dtype`."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            arr = np.asarray(node)
            flat[prefix] = arr.astype(dtype) if np.issubdtype(
                arr.dtype, np.floating) else arr

    walk("", params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)
    return path


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


def restore_params(path: str):
    """An npz weight file -> {'params': tree}, as the JAX package's
    `restore_params` returns for npz.  Orbax checkpoint directories are
    not ported (ROADMAP queue A7)."""
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: orbax checkpoint directories need the JAX package "
            "(ROADMAP queue A7); pass an npz weight file")
    return {"params": load_params_npz(path)}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

    def path(self, step: int, resume: bool = False) -> str:
        tail = ".resume.npz" if resume else ".npz"
        return os.path.join(self.directory, f"checkpoint_{step:04d}{tail}")

    def all_steps(self):
        steps = []
        for p in os.listdir(self.directory):
            m = re.fullmatch(r"checkpoint_(\d+)\.npz", p)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, step: int, state) -> str:
        """Write `state`'s (a `train.state.TrainState`) parameter tree and
        resume arrays; keep the newest `keep` checkpoints."""
        path = save_params_npz(self.path(step), state.params_tree())
        np.savez_compressed(self.path(step, resume=True),
                            **state.resume_arrays())
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            for resume in (False, True):
                if os.path.exists(self.path(s, resume)):
                    os.remove(self.path(s, resume))
        return path

    def restore(self, step: int = None):
        """The resume arrays of `step` (default the newest) as a dict, or
        None when there is no checkpoint."""
        steps = self.all_steps()
        if not steps:
            return None
        step = steps[-1] if step is None else step
        with np.load(self.path(step, resume=True)) as z:
            return {k: z[k] for k in z.files}

    def restore_into(self, state, step: int = None):
        """Partial restore: entries present in both the checkpoint and the
        state, with equal shapes, are taken from the checkpoint.  Returns
        (state, whether a checkpoint was found)."""
        arrays = self.restore(step)
        if arrays is None:
            return state, False
        state.load_resume_arrays(arrays)
        return state, True
