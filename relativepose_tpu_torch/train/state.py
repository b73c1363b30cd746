"""The state of a training run: its networks, Adam and the step count.

The JAX package carries a params pytree and an optax state; here the
parameters live in `nn.Module`s and Adam is `torch.optim.Adam` with the
same hyper-parameters (lr 2e-4, betas (0.5, 0.999), eps 1e-8).
`params_tree` gives the trained networks as the Flax-keyed tree that
`utils/checkpoint.py::save_params_npz` writes in the JAX package's npz
format; `resume_arrays` / `load_resume_arrays` carry everything a resumed
run needs (f32 parameters, Adam moments and steps) under torch names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from relativepose_tpu_torch.models import convert


@dataclasses.dataclass
class TrainState:
    models: dict                 # name -> trained nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # the model whose tree is the whole params tree (SCNet for completion:
    # its npz holds SCNet keys at the root, as the JAX package's does)
    root: Optional[str] = None
    frozen: dict = dataclasses.field(default_factory=dict)

    def parameters(self):
        return [p for m in self.models.values() for p in m.parameters()]

    def named_parameters(self):
        return [(f"{name}.{k}", p) for name, m in self.models.items()
                for k, p in m.named_parameters()]

    def params_tree(self) -> dict:
        if self.root is not None:
            return convert.flax_params(self.models[self.root])
        return {name: convert.flax_params(m)
                for name, m in self.models.items()}

    def resume_arrays(self) -> dict:
        """Flat dict of f32 numpy arrays: param/<name>, exp_avg/<name>,
        exp_avg_sq/<name>, adam_step/<name> and step."""
        out = {"step": np.asarray(self.step, np.int64)}
        for name, p in self.named_parameters():
            out[f"param/{name}"] = p.detach().float().cpu().numpy()
            st = self.optimizer.state.get(p, {})
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st:
                    out[f"{k}/{name}"] = st[k].float().cpu().numpy()
            if "step" in st:
                out[f"adam_step/{name}"] = np.asarray(
                    float(st["step"]), np.float32)
        return out

    def load_resume_arrays(self, arrays: dict):
        """Take every entry of `arrays` whose name and shape match this
        state (a partial restore)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                a = arrays.get(f"param/{name}")
                if a is not None and tuple(a.shape) == tuple(p.shape):
                    p.copy_(torch.from_numpy(np.asarray(a)))
                st = {}
                for k in ("exp_avg", "exp_avg_sq"):
                    a = arrays.get(f"{k}/{name}")
                    if a is not None and tuple(a.shape) == tuple(p.shape):
                        st[k] = torch.from_numpy(np.asarray(a)).to(p)
                a = arrays.get(f"adam_step/{name}")
                if len(st) == 2 and a is not None:
                    st["step"] = torch.tensor(float(a))
                    self.optimizer.state[p] = st
        if "step" in arrays:
            self.step = int(arrays["step"])


def make_optimizer(params, lr: float, b1: float, b2: float):
    """Adam with zero gradients in place: every parameter is stepped from
    the first step on, also one that a loss did not reach, as optax
    steps every leaf of the tree."""
    params = list(params)
    for p in params:
        p.grad = torch.zeros_like(p)
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8)


def grad_norm(params):
    """Global L2 norm of the gradients of `params` (a 0-d tensor)."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([p.grad for p in params])))


def init_models(build, seed: int):
    """Call build() with torch's RNG seeded by `seed`, leaving the
    caller's RNG state as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()
