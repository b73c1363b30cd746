"""Sigma tuning: the 4 matching sigmas (angle1, angle2, dist, feat) fitted
per recurrence level against cached matching primitives.

Port of `relativepose_tpu/tune/sigma.py`.  The objective, the sum over
pairs of ||R_hat(sigma) - R_gt||_F^2, is one batched solver call over the
stacked primitive sets of a level (`make_objective`).  Two optimizers:
  * `fd_optimize`: the original's randomized finite differences (10
    perturbations of +-10 %, a least-squares gradient, a backtracking line
    search), in numpy float64 with the same `RandomState` draws as the JAX
    package;
  * `grad_optimize`: Adam on log-sigma through autograd of the same
    objective.  The CUDA pair-weight kernel has no backward, so this path
    needs `SolverStaticConfig(pallas_w_build=False)`.
`cache_primitives` runs the recurrent pipeline once and records the
solver-ready primitive sets of every level, in the JAX package's cache
format: a list [levels][pairs] of (prim_s, prim_t) numpy dicts, and an
`.npy` file {"primitives", "R_gt"} (pickled), so a cache written by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from relativepose_tpu_torch.match.solver import (
    SolverHyperParams,
    SolverStaticConfig,
    estimate_relative_pose,
)
from relativepose_tpu_torch.pipeline.recurrent import (
    as_pair_batch,
    estimate_pose_via_completion,
)
from relativepose_tpu_torch.train.state import OptaxAdam

SIGMA0 = (0.2615, 0.2615, 0.04, 0.01)


@dataclasses.dataclass
class FDConfig:
    max_iter: int = 30
    n_perturb: int = 10
    perturb_scale: float = 0.1   # +-10 %
    n_linesearch: int = 10
    seed: int = 0


def make_objective(primitives_s, primitives_t, R_gt,
                   cfg: Optional[SolverStaticConfig] = None) -> Callable:
    """objective(sigmas [4]) -> 0-d tensor, the sum of ||R_hat - R_gt||_F^2.

    primitives_*: solver-ready dicts of [P, ...] tensors (`stack_
    primitives`); R_gt: [P, 3, 3].  The sigmas may be an array or a
    tensor that carries a graph; they are taken as f32."""
    cfg = cfg or SolverStaticConfig()
    device = primitives_s["pc"].device
    R_gt = torch.as_tensor(np.asarray(R_gt), dtype=torch.float32,
                           device=device)

    def objective(sig):
        sig = torch.as_tensor(sig, dtype=torch.float32).to(device)
        hp = SolverHyperParams(sigma_angle1=sig[0], sigma_angle2=sig[1],
                               sigma_dist=sig[2], sigma_feat=sig[3])
        T = estimate_relative_pose(primitives_s, primitives_t, hp, cfg)
        return torch.sum((T[:, :3, :3] - R_gt) ** 2)

    return objective


def _value(objective, sigma) -> float:
    with torch.no_grad():
        return float(objective(np.asarray(sigma, np.float32)))


def fd_optimize(objective: Callable, sigma0, fd: FDConfig = FDConfig(),
                log_fn=print):
    """Randomized finite-difference descent with a backtracking line
    search.  Returns (best sigma [4] float64, history of (loss, sigma))."""
    rng = np.random.RandomState(fd.seed)
    sigma = np.asarray(sigma0, np.float64).copy()
    loss = _value(objective, sigma)
    history = [(loss, sigma.copy())]
    for it in range(fd.max_iter):
        deltas = (rng.rand(fd.n_perturb, 4) - 0.5) * 2 * fd.perturb_scale
        deltas = deltas * sigma[None, :]
        vals = np.array([_value(objective, sigma + d) for d in deltas])
        grad, *_ = np.linalg.lstsq(deltas, vals - loss, rcond=None)
        gn = np.linalg.norm(grad)
        if gn < 1e-12:
            break
        step = 0.1 * np.linalg.norm(sigma) / gn
        improved = False
        for _ in range(fd.n_linesearch):
            cand = sigma - step * grad
            if np.all(cand > 0):
                cand_loss = _value(objective, cand)
                if cand_loss < loss:
                    sigma, loss, improved = cand, cand_loss, True
                    break
            step *= 0.5
        log_fn(f"[fd] iter {it}: loss {loss:.6f} sigma {sigma}")
        history.append((loss, sigma.copy()))
        if not improved:
            break
    return sigma, history


def grad_optimize(objective, sigma0, steps: int = 150, lr: float = 0.03,
                  log_fn=print, val_objective: Optional[Callable] = None):
    """Adam (optax's defaults, learning rate `lr`) on log-sigma, with the
    exact gradient of `objective` by autograd; log-sigma keeps the sigmas
    positive.  Each iteration pairs the loss with the sigma it was
    evaluated at, and one extra iteration scores the final iterate.
    Returns (best sigma [4] f32, history of (loss, score, sigma)): best by
    `val_objective` when given, else by the training loss."""
    log_sig = torch.log(torch.tensor(sigma0, dtype=torch.float32))
    log_sig.requires_grad_(True)
    opt = OptaxAdam([log_sig], lr=lr)

    def score(sig):
        return _value(val_objective, sig.numpy())

    sig = torch.exp(log_sig).detach()
    best = (sig.numpy(), score(sig) if val_objective else np.inf)
    history = []
    for it in range(steps + 1):
        opt.zero_grad()
        loss = objective(torch.exp(log_sig))
        loss.backward()
        loss = float(loss.detach())
        sig = torch.exp(log_sig).detach()
        cur = score(sig) if val_objective else loss
        history.append((loss, cur, sig.numpy()))
        if cur < best[1]:
            best = (sig.numpy(), cur)
        if (it + 1) % 25 == 0:
            val = f"val {cur:.6f} " if val_objective else ""
            log_fn(f"[grad] step {it + 1}: train {loss:.6f} {val}"
                   f"sigma {sig.numpy().round(4)}")
        if it < steps:
            opt.step()
    return best[0], history


def cache_primitives(scnet_fn_factory, batches, hp_table, pipe_cfg,
                     generator=None, draws=None,
                     cache_path: Optional[str] = None, scnet_params=None,
                     device="cuda"):
    """Run the recurrent pipeline once over each batch of pairs and record
    the solver-ready primitive sets of every recurrence level.

    scnet_fn_factory(data_s, data_t, params) -> completion fn
    (`cli/evaluate.py::scnet_fn_factory_from_checkpoint`).  batches:
    iterable of (data_s, data_t, T_gt[, n_valid]) with a leading pair
    dimension (`data.datasets.batched`; only the first n_valid pairs are
    kept).  draws: per batch, the per-step `KeypointDraws`, else drawn
    from `generator`.  Returns (primitives_by_level [levels][pairs]
    (prim_s, prim_t) numpy dicts, R_gt [P, 3, 3]); saved to `cache_path`
    when given."""
    by_level = [[] for _ in range(pipe_cfg.alter_steps)]
    rgts = []
    with torch.no_grad():
        for i, item in enumerate(batches):
            data_s, data_t, T_gt = item[:3]
            ds = as_pair_batch(data_s, device)
            dt = as_pair_batch(data_t, device)
            _, prims = estimate_pose_via_completion(
                scnet_fn_factory(ds, dt, scnet_params), ds, dt, hp_table,
                pipe_cfg, draws=None if draws is None else draws[i],
                generator=generator, return_primitives=True, device=device)
            n = item[3] if len(item) > 3 else ds["rgb"].shape[0]
            for lvl, (ps, pt) in enumerate(prims):
                ps = {k: v.cpu().numpy() for k, v in ps.items()}
                pt = {k: v.cpu().numpy() for k, v in pt.items()}
                by_level[lvl].extend(
                    ({k: v[j] for k, v in ps.items()},
                     {k: v[j] for k, v in pt.items()}) for j in range(n))
            rgts.append(np.asarray(T_gt, np.float32)[:n, :3, :3])
    rgt = np.concatenate(rgts)
    if cache_path:
        np.save(cache_path, {"primitives": by_level, "R_gt": rgt},
                allow_pickle=True)
    return by_level, rgt


def stack_primitives(prims, device="cuda"):
    """List of (prim_s, prim_t) dicts of one pair each -> two dicts of
    [P, ...] tensors on `device`."""
    def stack(dicts):
        return {k: torch.as_tensor(np.stack([np.asarray(d[k])
                                             for d in dicts]), device=device)
                for k in dicts[0]}

    return stack([p[0] for p in prims]), stack([p[1] for p in prims])


def tune_per_level(primitives_by_level, R_gt, sigma0=None,
                   fd: FDConfig = FDConfig(),
                   cfg: Optional[SolverStaticConfig] = None,
                   method: str = "fd", val_frac: float = 0.0,
                   grad_steps: int = 150, grad_lr: float = 0.03,
                   device="cuda"):
    """A sigma row per recurrence level -> [levels, 4] table (the format of
    `data/params/final_param_*_rlevel_3.txt`).

    method 'fd' (finite differences) or 'grad' (exact-gradient Adam).
    val_frac > 0 holds out the last val_frac of the pairs of each level: a
    tuned row is kept only if it beats sigma0 on their objective, else the
    row is sigma0."""
    sigma0 = np.asarray(sigma0 if sigma0 is not None else SIGMA0)
    rg = np.asarray(R_gt)
    rows = []
    for level, prims in enumerate(primitives_by_level):
        n_val = int(len(prims) * val_frac)
        tr, va = (prims[:-n_val], prims[-n_val:]) if n_val else (prims, [])
        rg_tr, rg_va = (rg[:-n_val], rg[-n_val:]) if n_val else (rg, None)
        obj = make_objective(*stack_primitives(tr, device), rg_tr, cfg)
        val_obj = None
        if va:
            val_obj = make_objective(*stack_primitives(va, device), rg_va,
                                     cfg)

        def log(m, level=level):
            print(f"level {level} {m}")

        if method == "grad":
            sig, _ = grad_optimize(obj, sigma0, steps=grad_steps,
                                   lr=grad_lr, log_fn=log,
                                   val_objective=val_obj)
        else:
            sig, _ = fd_optimize(obj, sigma0, fd, log_fn=log)
        if val_obj is not None:
            v_tuned = _value(val_obj, sig)
            v_base = _value(val_obj, sigma0)
            if v_tuned >= v_base:
                print(f"level {level}: tuned sigma rejected on held-out "
                      f"({v_tuned:.6f} >= {v_base:.6f}); keeping defaults")
                sig = sigma0.copy()
            else:
                print(f"level {level}: tuned sigma accepted "
                      f"({v_tuned:.6f} < {v_base:.6f})")
        rows.append(sig)
    return np.stack(rows)
