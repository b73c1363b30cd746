"""The state of a training run: its networks, Adam and the step count.

The JAX package carries a params pytree and an optax state; here the
parameters live in `nn.Module`s and Adam is `torch.optim.Adam` with the
same hyper-parameters (lr 2e-4, betas (0.5, 0.999), eps 1e-8).  Pose
fine-tuning and sigma tuning step `OptaxAdam`, whose updates equal
optax's.
`params_tree` gives the trained networks as the Flax-keyed tree that
`utils/checkpoint.py::save_params_npz` writes in the JAX package's npz
format; `resume_arrays` / `load_resume_arrays` carry everything a resumed
run needs (f32 parameters, Adam moments and steps) under torch names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

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
    # set by train.mesh.shard_train_state: the mesh, and the trained
    # networks wrapped for data parallelism
    mesh: Any = None
    wrapped: dict = dataclasses.field(default_factory=dict)

    def module(self, name: str):
        """The network to call in a training step: its data-parallel
        wrapper where there is one."""
        return self.wrapped.get(name, self.models[name])

    @property
    def data_group(self):
        """The process group the step's batch statistics and loss sums
        reduce over (None on one rank)."""
        return None if self.mesh is None else self.mesh.data_group

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


class OptaxAdam(torch.optim.Optimizer):
    """`optax.adam`, in multi-tensor (`torch._foreach_*`) ops that round
    as optax's do: the bias corrections 1 - b^t, computed in f32 as optax
    computes them, divide the moments, and eps is added to sqrt(nu_hat).
    (`torch.optim.Adam` takes the corrections in double precision: f32's
    1 - 0.999 is 1.3e-5 off, which moves an update by 6e-6 relative.  The
    feature and completion trainers keep it: on SCNet's parameters this
    class steps in 2.5-2.9 ms against its 1.4-1.9 ms on an H100 80GB HBM3
    at 700 W, `train/bench_adam.py`.)  The state has torch Adam's keys, so
    `TrainState.resume_arrays` carries it."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            for p in ps:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
            sts = [self.state[p] for p in ps]
            torch._foreach_add_([st["step"] for st in sts], 1.0)
            ts = [float(st["step"]) for st in sts]
            corr = {t: [float(np.float32(1.0) - np.float32(b) ** np.float32(t))
                        for b in (b1, b2)] for t in set(ts)}
            bc1 = [corr[t][0] for t in ts]
            bc2 = [corr[t][1] for t in ts]
            gs = [p.grad for p in ps]
            ms = [st["exp_avg"] for st in sts]
            vs = [st["exp_avg_sq"] for st in sts]
            # (1 - b) * g + b * m, each product rounded
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - b1))
            torch._foreach_mul_(vs, b2)
            g2 = torch._foreach_mul(gs, gs)
            torch._foreach_mul_(g2, 1.0 - b2)
            torch._foreach_add_(vs, g2)
            den = torch._foreach_div(vs, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(ms, bc1)
            torch._foreach_div_(upd, den)
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(ps, upd)


def make_optimizer(params, lr: float, b1: float, b2: float):
    """`torch.optim.Adam` with zero gradients in place: every parameter
    is stepped from the first step on, also one that a loss did not
    reach, as optax steps every leaf of the tree."""
    params = list(params)
    for p in params:
        p.grad = torch.zeros_like(p)
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8)


def grad_norm(params):
    """Global L2 norm of the gradients of `params` (a 0-d tensor); the
    squares of a parameter split over a model group (`train/mesh.py`) are
    summed over that group."""
    full = [p.grad for p in params if getattr(p, "shard", None) is None]
    split = [p for p in params if getattr(p, "shard", None) is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(full)))
    if not split:
        return norm
    import torch.distributed as dist
    sq = torch.stack(torch._foreach_norm([p.grad for p in split])).square()
    sq = sq.sum()
    dist.all_reduce(sq, group=split[0].shard.group)
    return torch.sqrt(norm.square() + sq)


def init_models(build, seed: int):
    """Call build() with torch's RNG seeded by `seed`, leaving the
    caller's RNG state as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()
