"""npz weight files, numbered training checkpoints, and the JAX package's
orbax checkpoint directories, read without JAX.

`save_params_npz` / `load_params_npz` are the JAX package's npz format
(`relativepose_tpu/utils/checkpoint.py`): one compressed npz per parameter
tree, '/'-joined keys, floats in f16 by default, the format of the shipped
`relativepose_tpu/data/pretrained/*.npz` files.  Each package reads what
the other writes; `models/convert.py` maps the tree to and from the port's
modules.

`restore_params` also takes an orbax checkpoint manager directory (the
JAX training CLIs' `experiments/exp_<name>/params`): its newest
`checkpoint_%04d/` is read by `utils/orbax_read.py`, bit for bit.

`CheckpointManager` keeps the JAX package's numbered `checkpoint_%04d`,
keep-N and partial-restore semantics without orbax (which needs JAX):
each save writes `checkpoint_%04d.npz`, the trained networks' parameter
tree in the npz format above, and beside it `checkpoint_%04d.resume.npz`,
everything a resumed run needs in f32 (`train/state.py`), uncompressed.
It also reads the orbax `checkpoint_%04d/` directories that the JAX
package's manager writes into the same directory, so that a TPU run
resumes here; it writes npz only.
"""

from __future__ import annotations

import os
import re

import numpy as np

from relativepose_tpu_torch.utils import orbax_read


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


def orbax_steps(directory: str) -> list:
    """The steps of the orbax `checkpoint_%04d/` directories in a manager
    directory (the JAX package's `CheckpointManager`), sorted."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(
        re.compile(r"checkpoint_(\d+)").fullmatch, os.listdir(directory))
        if m and orbax_read.is_checkpoint(os.path.join(directory,
                                                       m.group(0))))


def restore_params(path: str):
    """An npz weight file -> {'params': tree}; an orbax checkpoint manager
    directory -> the state dict saved in its newest checkpoint, whose
    ['params'] is the parameter tree; as the JAX package's
    `restore_params` returns them.  Raises FileNotFoundError for a
    directory that holds no checkpoint."""
    if path.endswith(".npz"):
        return {"params": load_params_npz(path)}
    steps = orbax_steps(path)
    if not steps:
        raise FileNotFoundError(f"{path}: no orbax checkpoint_<step> "
                                "directory")
    return orbax_read.restore(os.path.join(path,
                                           f"checkpoint_{steps[-1]:04d}"))


def require_checkpoint(path: str):
    """Raise unless `path` names an npz weight file or an orbax manager
    directory that holds a checkpoint (what `restore_params` reads)."""
    if path.endswith(".npz"):
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
    elif not orbax_steps(path):
        raise FileNotFoundError(
            f"{path}: neither an npz weight file nor an orbax checkpoint "
            "manager directory with a checkpoint_<step>/ in it")


class CheckpointManager:
    """Numbered checkpoints in `directory`: the port's npz pairs, and the
    JAX package's orbax `checkpoint_%04d/` directories, which it reads.
    The newest step of either format is restored; on a tie the port's
    npz wins.  keep-N counts and deletes the port's own npz checkpoints
    only: it never deletes a directory that the port did not write."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

    def path(self, step: int, resume: bool = False) -> str:
        tail = ".resume.npz" if resume else ".npz"
        return os.path.join(self.directory, f"checkpoint_{step:04d}{tail}")

    def npz_steps(self):
        steps = []
        for p in os.listdir(self.directory):
            m = re.fullmatch(r"checkpoint_(\d+)\.npz", p)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def all_steps(self):
        """Every step, npz or orbax, sorted."""
        return sorted(set(self.npz_steps()) | set(orbax_steps(self.directory)))

    def save(self, step: int, state) -> str:
        """Write `state`'s (a `train.state.TrainState`) parameter tree and
        resume arrays; keep the newest `keep` npz checkpoints."""
        path = save_params_npz(self.path(step), state.params_tree())
        # uncompressed: f32 weights and Adam moments barely compress, and
        # zlib over SCNet's 146 M values was most of a short training
        # run's time (chip_smoke.py 6b, 7b)
        np.savez(self.path(step, resume=True), **state.resume_arrays())
        steps = self.npz_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            for resume in (False, True):
                if os.path.exists(self.path(s, resume)):
                    os.remove(self.path(s, resume))
        return path

    def _pick(self, step):
        """(step, whether it is an orbax directory) of `step` (default the
        newest), or None when there is no checkpoint."""
        steps = self.all_steps()
        if not steps:
            return None
        step = steps[-1] if step is None else step
        return step, step not in self.npz_steps()

    def restore(self, step: int = None):
        """`step`'s checkpoint (default the newest): the resume arrays of an
        npz checkpoint as a dict, or the state tree of an orbax one (what
        the JAX package's manager restores); None when there is none."""
        picked = self._pick(step)
        if picked is None:
            return None
        step, orbax = picked
        if orbax:
            return orbax_read.restore(
                os.path.join(self.directory, f"checkpoint_{step:04d}"))
        with np.load(self.path(step, resume=True)) as z:
            return {k: z[k] for k in z.files}

    def restore_into(self, state, step: int = None):
        """Partial restore: entries present in both the checkpoint and the
        state, with equal shapes, are taken from the checkpoint; a JAX
        trainer state is mapped onto the port's names first
        (`TrainState.load_flax_state`).  Returns (state, whether a
        checkpoint was found)."""
        picked = self._pick(step)
        if picked is None:
            return state, False
        tree = self.restore(picked[0])
        if picked[1]:
            state.load_flax_state(tree)
        else:
            state.load_resume_arrays(tree)
        return state, True
