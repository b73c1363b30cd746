"""npz weight files, numbered training checkpoints, and the JAX package's
orbax checkpoint directories, read without JAX.

`save_params_npz` / `load_params_npz` are the JAX package's npz format
(`relativepose_tpu/utils/checkpoint.py`): one compressed npz per parameter
tree, '/'-joined keys, floats in f16 by default, the format of the shipped
`relativepose_tpu/data/pretrained/*.npz` files.  Each package reads what
the other writes; `models/convert.py` maps the tree to and from the port's
modules.

`restore_params` also takes a checkpoint manager directory (the training
CLIs' `experiments/exp_<name>/params`) and reads its newest step: an orbax
`checkpoint_%04d/` by `utils/orbax_read.py`, bit for bit, or the
`checkpoint_%04d.npz` that the port's manager wrote before it wrote orbax.

`CheckpointManager` is the JAX package's manager without orbax (which
needs JAX): numbered checkpoints, keep-N and partial restore.  Each save
writes the orbax `checkpoint_%04d/` directory that the JAX package's
manager writes for the same state tree (`utils/orbax_write.py`; the
trainers' tree is `train/state.py::TrainState.flax_state`), so either
package resumes or evaluates what the other trained.  It still reads the
npz pairs of earlier port runs: `checkpoint_%04d.npz`, the parameter tree
in the npz format above, and `checkpoint_%04d.resume.npz`, everything a
resumed run needs in f32 under torch names.
"""

from __future__ import annotations

import os
import re
import shutil

import numpy as np

from relativepose_tpu_torch.utils import orbax_read, orbax_write


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
    directory, sorted."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(
        re.compile(r"checkpoint_(\d+)").fullmatch, os.listdir(directory))
        if m and orbax_read.is_checkpoint(os.path.join(directory,
                                                       m.group(0))))


def npz_steps(directory: str) -> list:
    """The steps of the npz checkpoints `checkpoint_%04d.npz` in a manager
    directory, sorted."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(
        re.compile(r"checkpoint_(\d+)\.npz").fullmatch,
        os.listdir(directory)) if m)


def all_steps(directory: str) -> list:
    """Every step of a manager directory, npz or orbax, sorted."""
    return sorted(set(npz_steps(directory)) | set(orbax_steps(directory)))


def newest_step(directory: str, step: int = None):
    """(step, whether it is an orbax directory) of `step` (default the
    newest step of either format) in a manager directory, or None when it
    holds no checkpoint.  On a tie the npz wins, as it did when the port
    wrote npz beside the JAX package's orbax steps."""
    steps = all_steps(directory)
    if not steps:
        return None
    step = steps[-1] if step is None else step
    return step, step not in npz_steps(directory)


def restore_params(path: str):
    """An npz weight file -> {'params': tree}; a checkpoint manager
    directory -> its newest checkpoint: an orbax one's saved state dict,
    whose ['params'] is the parameter tree, or an npz one's {'params':
    tree}; as the JAX package's `restore_params` returns them.  Raises
    FileNotFoundError for a directory that holds no checkpoint."""
    if path.endswith(".npz"):
        return {"params": load_params_npz(path)}
    picked = newest_step(path)
    if picked is None:
        raise FileNotFoundError(f"{path}: no orbax checkpoint_<step> "
                                "directory and no checkpoint_<step>.npz")
    step, orbax = picked
    if orbax:
        return orbax_read.restore(os.path.join(path,
                                               f"checkpoint_{step:04d}"))
    return {"params": load_params_npz(
        os.path.join(path, f"checkpoint_{step:04d}.npz"))}


def require_checkpoint(path: str):
    """Raise unless `path` names an npz weight file or a checkpoint
    manager directory that holds a checkpoint (what `restore_params`
    reads)."""
    if path.endswith(".npz"):
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
    elif newest_step(path) is None:
        raise FileNotFoundError(
            f"{path}: neither an npz weight file nor a checkpoint manager "
            "directory with a checkpoint_<step>/ or checkpoint_<step>.npz "
            "in it")


class CheckpointManager:
    """Numbered checkpoints in `directory`, as the JAX package's manager
    keeps them: each save writes an orbax `checkpoint_%04d/`; restores
    take the newest step of either format, the port's earlier npz pairs
    included (on a tie the npz wins); keep-N deletes the oldest steps of
    either format, as the JAX manager deletes its oldest."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{step:04d}")

    def npz_path(self, step: int, resume: bool = False) -> str:
        tail = ".resume.npz" if resume else ".npz"
        return self.path(step) + tail

    def all_steps(self):
        """Every step, npz or orbax, sorted."""
        return all_steps(self.directory)

    def _delete(self, step: int, orbax: bool = True):
        if orbax:
            shutil.rmtree(self.path(step), ignore_errors=True)
        for resume in (False, True):
            if os.path.exists(self.npz_path(step, resume)):
                os.remove(self.npz_path(step, resume))

    def save(self, step: int, state) -> str:
        """Write `state` as the orbax `checkpoint_%04d/` of `step`: a
        `train.state.TrainState`, as its `flax_state()` (the JAX trainers'
        tree), or a dict tree as it is; replaces the step's checkpoint of
        either format, then keeps the newest `keep` steps.  Returns the
        directory's path."""
        tree = state.flax_state() if hasattr(state, "flax_state") else state
        self._delete(step, orbax=False)   # the write replaces the orbax one
        path = orbax_write.save(self.path(step), tree)
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            self._delete(s)
        return path

    def restore(self, step: int = None):
        """`step`'s checkpoint (default the newest): the state tree of an
        orbax one (what the JAX package's manager restores), or the resume
        arrays of an npz one as a dict; None when there is none."""
        picked = newest_step(self.directory, step)
        if picked is None:
            return None
        step, orbax = picked
        if orbax:
            return orbax_read.restore(self.path(step))
        with np.load(self.npz_path(step, resume=True)) as z:
            return {k: z[k] for k in z.files}

    def restore_into(self, state, step: int = None):
        """Partial restore: entries present in both the checkpoint and the
        state, with equal shapes, are taken from the checkpoint; an orbax
        trainer state (the JAX package's or the port's) is mapped onto the
        port's names first (`TrainState.load_flax_state`).  Returns
        (state, whether a checkpoint was found)."""
        picked = newest_step(self.directory, step)
        if picked is None:
            return state, False
        tree = self.restore(picked[0])
        if picked[1]:
            state.load_flax_state(tree)
        else:
            state.load_resume_arrays(tree)
        return state, True
