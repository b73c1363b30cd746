"""Experiment directory conventions and resume semantics.

Port of `relativepose_tpu/utils/experiment.py`: every run lives in
`experiments/exp_<name>/` with `samples/`, `params/` and a log; `rm`
wipes an earlier run of the same name, `resume` requires one.
"""

from __future__ import annotations

import os
import shutil


class ExperimentDirs:
    def __init__(self, name: str, root: str = "experiments",
                 rm: bool = False, resume: bool = False):
        self.name = name
        self.exp_dir = os.path.join(root, f"exp_{name}")
        self.samples_dir = os.path.join(self.exp_dir, "samples")
        self.params_dir = os.path.join(self.exp_dir, "params")
        self.log_path = os.path.join(self.exp_dir, f"exp_{name}.log")
        exists = os.path.exists(self.exp_dir)
        if rm and exists:
            shutil.rmtree(self.exp_dir)
            exists = False
        if resume and not exists:
            raise FileNotFoundError(
                f"--resume requires existing experiment {self.exp_dir}")
        has_params = os.path.isdir(self.params_dir) and bool(
            os.listdir(self.params_dir))
        if not resume and exists and has_params:
            raise FileExistsError(
                f"experiment {self.exp_dir} exists; pass rm=True or "
                f"resume=True")
        for d in (self.exp_dir, self.samples_dir, self.params_dir):
            os.makedirs(d, exist_ok=True)



def parameters_count(model, name: str = "model"):
    """Print and return the parameter count of an nn.Module."""
    n = sum(p.numel() for p in model.parameters())
    print(f"{name} #param: {n / 1e6:.2f}M")
    return n
