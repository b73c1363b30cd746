"""Evaluation harness: per-overlap-bucket pose-error statistics.

Port of `relativepose_tpu/eval/harness.py` (methods ours / ours_nr /
ours_nc), with the protocol of the original evaluation.py:
  * GT relative pose R_gt = R_tgt @ inv(R_src);
  * overlap buckets {0-0.1, 0.1-0.5, 0.5-1.0};
  * rotation error = geodesic degrees; translation error =
    ||(R_hat - R_gt) @ mean(pc_src) + t_hat - t_gt||, plus the 'blind'
    columns;
  * results appended to `<exp>.result.npy` every `save_every` pairs, with
    resume-by-count.

The batched eval fn runs `batch_pairs` pano pairs through the recurrent
pipeline per call, on one device.  The classical baselines' per-pair loop
is `eval/baselines.py`.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from relativepose_tpu_torch import config
from relativepose_tpu_torch.core import overlap as overlap_mod
from relativepose_tpu_torch.core import skybox
from relativepose_tpu_torch.core.rotation import angular_distance
from relativepose_tpu_torch.match.solver import SolverHyperParams
from relativepose_tpu_torch.pipeline.recurrent import (
    PipelineConfig,
    as_pair_batch,
    estimate_pose_via_completion,
)

OVERLAP_BUCKETS = ("0-0.1", "0.1-0.5", "0.5-1.0")
CLASSICAL_METHODS = ("super4pcs", "fgs", "gs", "cgs")
PARAMS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "params")


def bucket_of(overlap_val: float) -> str:
    return ("0-0.1" if overlap_val <= 0.1
            else "0.1-0.5" if overlap_val <= 0.5 else "0.5-1.0")


@dataclasses.dataclass
class EvalConfig:
    dataset: str = "suncg"
    method: str = "ours"
    exp: str = "eval"
    out_dir: str = "tmp/rpe"
    max_iter: int = 1000
    num_repeat: int = 1
    save_every: int = 100
    batch_pairs: int = 4
    resume: bool = True
    sigma_table: Optional[np.ndarray] = None  # [steps, 4] like --para files
    per_step_errors: bool = False  # record rot/trans error after each step
    # the reference's --alterStep; None = 1 for ours_nr, else 3
    alter_steps_override: Optional[int] = None

    @property
    def alter_steps(self) -> int:
        if self.alter_steps_override is not None:
            return self.alter_steps_override
        return 1 if self.method == "ours_nr" else 3

    @property
    def completion(self) -> bool:
        return self.method != "ours_nc"


def default_sigma_table(dataset: str) -> np.ndarray:
    """The tuned rlevel-3 sigma table of a dataset [3, 4] (copies of the
    reference's final_param_*_rlevel_3.txt in `data/params/`)."""
    path = os.path.join(PARAMS_DIR, f"final_param_"
                        f"{config.canonical_dataset(dataset)}_rlevel_3.txt")
    if os.path.exists(path):
        return np.loadtxt(path).reshape(-1, 4)
    return np.tile([0.2615, 0.2615, 0.04, 0.01], (3, 1))


def hyper_params_from_table(table: Optional[np.ndarray],
                            alter_steps: Optional[int] = None
                            ) -> SolverHyperParams:
    """Per-step solver sigmas from a [steps, 4] --para table (f32 rows);
    a table with fewer rows than `alter_steps` raises ValueError."""
    if table is None:
        return SolverHyperParams(sigma_angle1=0.2615, sigma_angle2=0.2615,
                                 sigma_dist=0.04, sigma_feat=0.01)
    table = np.asarray(table)
    if alter_steps is not None and table.shape[0] < alter_steps:
        raise ValueError(
            f"sigma table has {table.shape[0]} rows but the pipeline runs "
            f"{alter_steps} recurrence steps — the --para file must have at "
            "least one row per step")
    t = torch.as_tensor(table, dtype=torch.float32)
    return SolverHyperParams(sigma_angle1=t[:, 0], sigma_angle2=t[:, 1],
                             sigma_dist=t[:, 2], sigma_feat=t[:, 3])


def parse_eval_data(depth, rgb, norm, dataset: str, method: str,
                    depth_full=None, rgb_full=None):
    """Observed-region point clouds and colours for the overlap, batched.

    suncg/matterport lift the second 160x160 face; scannet with an 'ours'
    method (or without `depth_full`) lifts the 66x88 kinect crop, and
    scannet with a classical method the 480x640 frame (`depth_full`
    [B, 480, 640], `rgb_full`).  depth: [B, 160, 640]; rgb: [B, 160, 640,
    3].  Returns (pc [B, N, 3], valid [B, N], colour [B, N, 3])."""
    del norm  # part of the reference's signature, unused as there
    ds = config.canonical_dataset(dataset)
    F = config.FACE
    b = depth.shape[0]
    if ds in ("suncg", "matterport"):
        pc, valid = skybox.face_depth_to_pointcloud(depth[:, :, F:2 * F], ds)
        c = rgb[:, :, F:2 * F].reshape(b, -1, 3)
    elif "ours" in method or depth_full is None:
        rows = slice(config.KINECT_ROW0, config.KINECT_ROW1)
        cols = slice(config.KINECT_COL0, config.KINECT_COL1)
        pc, valid = skybox.kinect_crop_to_pointcloud(depth[:, rows, cols])
        c = rgb[:, rows, cols].reshape(b, -1, 3)
    else:
        pc, valid = skybox.kinect_full_to_pointcloud(depth_full)
        c = (rgb_full.reshape(b, -1, 3) if rgb_full is not None
             else torch.zeros_like(pc))
    return pc, valid, c


def pose_errors(T_hat, T_gt, pc_src, src_valid):
    """Rotation geodesic and translation errors of poses [B, 4, 4].

    err_t_blind is the original's ||t_hat - t_gt|| (it depends on the
    method's own prediction); err_t_id is the identity pose's err_t,
    ||(I - R_gt) @ mean_pc - t_gt||.  Returns a dict of [B] tensors."""
    R_hat, t_hat = T_hat[:, :3, :3], T_hat[:, :3, 3]
    R_gt, t_gt = T_gt[:, :3, :3], T_gt[:, :3, 3]
    eye = torch.eye(3, dtype=R_gt.dtype, device=R_gt.device)
    w = src_valid.to(pc_src.dtype)
    mean_pc = torch.sum(pc_src * w[..., None], 1) / torch.clamp(
        torch.sum(w, -1), min=1.0)[:, None]

    def apply(M, x):
        return (M @ x[..., None])[..., 0]

    norm = torch.linalg.vector_norm
    return {
        "err_ad": angular_distance(R_hat, R_gt),
        "err_blind": angular_distance(R_gt, eye),
        "err_t": norm(apply(R_hat - R_gt, mean_pc) + t_hat - t_gt, dim=-1),
        "err_t_blind": norm(t_hat - t_gt, dim=-1),
        "err_t_id": norm(apply(eye - R_gt, mean_pc) - t_gt, dim=-1),
    }


def make_batched_eval_fn(scnet_fn_factory: Callable, cfg: EvalConfig,
                         pipe_cfg: PipelineConfig, device="cuda"):
    """Batched eval: pipeline poses, overlap and errors of a batch.

    scnet_fn_factory(data_s, data_t, params) -> completion fn, with
    data_s/data_t dicts of [B, ...] tensors on `device`.  Returns
    fn(data_s, data_t, T_gt, batch_seed, params, hp, draws=None) -> dict
    of [B, ...] numpy arrays; the keypoint draws come from a generator on
    `device` seeded with `batch_seed`, or are given per step as `draws`
    (`KeypointDraws` of [B, ...] tensors, e.g. the JAX package's)."""

    def eval_batch(data_s, data_t, T_gt, batch_seed, params, hp,
                   draws=None):
        ds = as_pair_batch(data_s, device)
        dt = as_pair_batch(data_t, device)
        T_gt = torch.as_tensor(T_gt, dtype=torch.float32, device=device)
        gen = torch.Generator(device=device).manual_seed(int(batch_seed))
        with torch.no_grad():
            T_hat, step_ts = estimate_pose_via_completion(
                scnet_fn_factory(ds, dt, params), ds, dt, hp, pipe_cfg,
                generator=gen, draws=draws, return_step_poses=True,
                device=device)
            pc_s, val_s, _ = parse_eval_data(
                ds["depth"], ds["rgb"], ds["norm"], cfg.dataset, cfg.method)
            pc_t, val_t, _ = parse_eval_data(
                dt["depth"], dt["rgb"], dt["norm"], cfg.dataset, cfg.method)
            ov = overlap_mod.point_cloud_overlap(pc_s, val_s, pc_t, val_t,
                                                 T_gt)
            out = {"T_hat": T_hat, **ov,
                   **pose_errors(T_hat, T_gt, pc_s, val_s)}
            if cfg.per_step_errors:
                b, steps = step_ts.shape[:2]
                se = pose_errors(step_ts.flatten(0, 1),
                                 T_gt.repeat_interleave(steps, 0),
                                 pc_s.repeat_interleave(steps, 0),
                                 val_s.repeat_interleave(steps, 0))
                out["rot_steps"] = se["err_ad"].reshape(b, steps)
                out["trans_steps"] = se["err_t"].reshape(b, steps)
        return {k: v.cpu().numpy() for k, v in out.items()}

    return eval_batch


def batch_seed(seed: int, repeat: int, batch_index: int) -> int:
    """The keypoint-draw seed of one (repeat, batch): a resumed run draws
    what the first run drew for the same batch."""
    return int(np.random.SeedSequence(
        [seed, repeat, batch_index]).generate_state(1)[0])


class EvalRunner:
    """Streaming evaluation with bucket statistics and resume-by-count."""

    def __init__(self, cfg: EvalConfig):
        self.cfg = cfg
        self.exp_dir = os.path.join(cfg.out_dir, cfg.exp)
        os.makedirs(self.exp_dir, exist_ok=True)
        self.result_path = os.path.join(self.exp_dir,
                                        f"{cfg.exp}.result.npy")
        self.error_stats = []
        self.ad_stats = {b: [] for b in OVERLAP_BUCKETS}
        self.t_stats = {b: [] for b in OVERLAP_BUCKETS}
        self.speed = []
        self.compile_s = None  # wall time of the first (warm-up) batch
        self.blind_stats = {b: [] for b in OVERLAP_BUCKETS}
        self.t_blind_stats = {b: [] for b in OVERLAP_BUCKETS}
        self.t_id_stats = {b: [] for b in OVERLAP_BUCKETS}
        self.step_stats = {b: [] for b in OVERLAP_BUCKETS}
        self.t_step_stats = {b: [] for b in OVERLAP_BUCKETS}
        if cfg.resume and os.path.exists(self.result_path):
            self.error_stats = list(
                np.load(self.result_path, allow_pickle=True))
            # replay earlier results so the summary covers the whole run
            for r in self.error_stats:
                self._accumulate(r)

    @property
    def n_done(self) -> int:
        """Completed (repeat, pair) iterations; a resumed run skips them."""
        return len(self.error_stats)

    def _accumulate(self, result: dict):
        b = bucket_of(float(result["overlap"]))
        self.ad_stats[b].append(float(result["err_ad"]))
        self.t_stats[b].append(float(result["err_t"]))
        if "err_blind" in result:
            self.blind_stats[b].append(float(result["err_blind"]))
        if "err_t_blind" in result:
            self.t_blind_stats[b].append(float(result["err_t_blind"]))
        if "err_t_id" in result:
            self.t_id_stats[b].append(float(result["err_t_id"]))
        if "rot_steps" in result:
            self.step_stats[b].append(np.asarray(result["rot_steps"]))
            self.t_step_stats[b].append(np.asarray(result["trans_steps"]))

    def record(self, result: dict):
        self._accumulate(result)
        self.error_stats.append(result)
        if len(self.error_stats) % self.cfg.save_every == 0:
            self.save()
            self.print_stats()

    def save(self):
        np.save(self.result_path, np.asarray(self.error_stats, dtype=object))

    def print_stats(self):
        for name, stats in (("rotation", self.ad_stats),
                            ("translation", self.t_stats)):
            line = ""
            for b in OVERLAP_BUCKETS:
                vals = stats[b]
                mean = np.mean(vals) if vals else float("nan")
                line += (f"{name}, overlap:{b}, nobs:{len(vals)}, "
                         f"mean:{mean:.4f}  ")
            print(line)

    def summary(self):
        def mean(vals):
            return float(np.mean(vals)) if vals else None

        out = {}
        for b in OVERLAP_BUCKETS:
            out[f"rot_{b}"] = mean(self.ad_stats[b])
            out[f"trans_{b}"] = mean(self.t_stats[b])
            out[f"rot_blind_{b}"] = mean(self.blind_stats[b])
            out[f"trans_blind_{b}"] = mean(self.t_blind_stats[b])
            out[f"trans_id_{b}"] = mean(self.t_id_stats[b])
            if self.step_stats[b]:
                out[f"rot_steps_{b}"] = [
                    float(v) for v in np.mean(self.step_stats[b], axis=0)]
                out[f"trans_steps_{b}"] = [
                    float(v) for v in np.mean(self.t_step_stats[b], axis=0)]
        if self.speed:
            out["sec_per_pair"] = float(np.mean(self.speed))
        if self.compile_s is not None:
            out["compile_s"] = float(self.compile_s)
        return out


def evaluate_stream(pairs, eval_fn, cfg: EvalConfig, seed: int = 0):
    """Run a batched eval fn over `cfg.num_repeat` passes of pair batches.

    pairs: a zero-arg callable returning a fresh iterable of (data_s,
    data_t, T_gt[, n_valid]) batches (needed for num_repeat > 1), or one
    iterable (a single pass).  eval_fn(data_s, data_t, T_gt, batch_seed)
    -> dict of [B, ...] arrays.  Each pass evaluates at most
    `cfg.max_iter` pairs; a batch may carry n_valid < batch size (a padded
    tail) and only its real rows are recorded.  All passes go into one
    result file.  On resume the first `runner.n_done` (repeat, pair)
    iterations are skipped; the draw seed of each (repeat, batch) is
    `batch_seed(seed, repeat, batch index)`, so a resumed run draws as
    the first run did.

    The first batch run is the warm-up (on the card: kernel builds, cuDNN
    autotuning, allocator growth): its wall time is `runner.compile_s`
    and it is left out of `sec_per_pair`.
    """
    runner = EvalRunner(cfg)
    skip = runner.n_done
    n_repeat = cfg.num_repeat if callable(pairs) else 1
    g = 0
    first_timed = True
    for rep in range(n_repeat):
        batches = pairs() if callable(pairs) else pairs
        done_this_rep = 0
        for bi, batch in enumerate(batches):
            if len(batch) == 4:
                data_s, data_t, T_gt, n_valid = batch
            else:
                (data_s, data_t, T_gt), n_valid = batch, batch[2].shape[0]
            n = int(min(n_valid, cfg.max_iter - done_this_rep))
            if n <= 0:
                break
            done_this_rep += n
            if g + n <= skip:  # whole batch already done
                g += n
                continue
            t0 = time.time()
            out = eval_fn(data_s, data_t, T_gt, batch_seed(seed, rep, bi))
            out = {k: np.asarray(v) for k, v in out.items()}
            dt = (time.time() - t0) / n
            is_compile = first_timed
            first_timed = False
            if is_compile:
                runner.compile_s = time.time() - t0
            for i in range(n):
                if g < skip:  # partly done batch: record only the tail
                    g += 1
                    continue
                res = {k: np.asarray(v[i]) for k, v in out.items()}
                res["sec_per_pair"] = dt
                res["repeat"] = rep
                if not is_compile:
                    runner.speed.append(dt)
                runner.record(res)
                g += 1
    runner.save()
    return runner
