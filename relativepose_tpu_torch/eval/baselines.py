"""Classical registration baselines (super4pcs / gs / fgs / cgs).

Port of `relativepose_tpu/eval/baselines.py`.  The registration runs in
the native library (`native/registration.py`, built from
`cpp/registration.cpp`): voxel downsampling, normals, FPFH features,
RANSAC global registration, fast global registration and coloured ICP,
the capabilities the original evaluation took from the Super4PCS binary
and Open3D.  The bookkeeping (the observed-region clouds and the pose
errors, `eval/harness.py`) runs in torch on `args.device`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from relativepose_tpu_torch.data import datasets as dsets
from relativepose_tpu_torch.eval import harness
from relativepose_tpu_torch.native import registration as natreg


def super4pcs(pc_src, pc_tgt, overlap: float = 0.5, delta: float = 0.1,
              time_budget_s: float = None, n_points: int = 200):
    """4PCS-style congruent-set registration with the original's arguments
    (-o 0.5 -d 0.1 -n 200); the identity when the search fails.

    The budget defaults to 240 s, the original's subprocess timeout, or
    to the environment variable RPTPU_S4PCS_BUDGET; the search also ends
    early on its LCP target or when it stagnates."""
    if time_budget_s is None:
        time_budget_s = float(os.environ.get("RPTPU_S4PCS_BUDGET", 240.0))
    try:
        return natreg.super4pcs(pc_src, pc_tgt, overlap, delta,
                                time_budget_s, n_points)
    except Exception:
        return np.eye(4)


def global_registration(pc_src, pc_tgt, voxel: float = 0.05):
    """FPFH + RANSAC."""
    return natreg.global_registration(pc_src, pc_tgt, voxel)


def fast_global_registration(pc_src, pc_tgt, voxel: float = 0.05):
    """Fast global registration (Geman-McClure)."""
    return natreg.fast_global_registration(pc_src, pc_tgt, voxel)


def colored_registration(pc_src, pc_tgt, color_src, color_tgt,
                         voxel: float = 0.05):
    """RANSAC initialisation + multi-scale coloured ICP."""
    return natreg.colored_registration(pc_src, pc_tgt, color_src,
                                       color_tgt, voxel)


METHODS = {
    "super4pcs": lambda s, t, cs, ct: super4pcs(s, t),
    "gs": lambda s, t, cs, ct: global_registration(s, t),
    "fgs": lambda s, t, cs, ct: fast_global_registration(s, t),
    "cgs": colored_registration,
}

_OV_KEYS = ("overlap", "cam_dist", "pc_dist", "pc_nn")


def run_classical_eval(args, cfg: harness.EvalConfig):
    """The per-pair host loop of the classical methods, with the
    original's skip of pairs whose overlap is below 0.1.

    Overlap statistics come from the native grid hash
    (`natreg.overlap_stats`), not the chunked-matmul path, which is
    O(N^2) in the cloud size.  For synthetic scenes they are cached on
    disk (`tmp/overlap_cache`) under the scene's identity, so the four
    methods compute them once per pair.  Skipped pairs leave no row, so a
    resumed run starts after the highest recorded pair index."""
    device = torch.device(getattr(args, "device", "cuda"))
    ov_cache_dir = None
    if "synthetic" in args.dataList:
        seed0 = getattr(args, "eval_seed", 20_000)
        source = dsets.SyntheticPairs(
            args.family, n=min(args.maxIter, 1000), seed=seed0,
            ramp_weight=getattr(args, "ramp_weight", 0.35),
            n_clutter=getattr(args, "n_clutter", 0))
        ov_cache_dir = os.path.join("tmp", "overlap_cache")
        os.makedirs(ov_cache_dir, exist_ok=True)

        def ov_key(i):
            tag = f"_rw{source.ramp_weight:g}" if source.ramp_weight != 0.35 \
                else ""
            tag += f"_cl{source.n_clutter}" if source.n_clutter else ""
            return os.path.join(ov_cache_dir,
                                f"{args.family}_{seed0 + i}{tag}.npz")
    else:
        source = dsets.PanoPairDataset(args.family, "test", args.listPath,
                                       entry_split=args.entrySplit)
    method = METHODS[args.method]
    runner = harness.EvalRunner(cfg)
    start = 0
    if runner.error_stats:
        start = 1 + max(int(r.get("pair_idx", -1))
                        for r in runner.error_stats)

    def tensor(view, key):
        # one pair as a batch of 1 on the bookkeeping device
        if key not in view:
            return None
        return torch.as_tensor(np.asarray(view[key]), dtype=torch.float32,
                               device=device)[None]

    def parse(view):
        # ScanNet's classical methods read the 480x640 frame; the other
        # datasets have none
        pc, val, col = harness.parse_eval_data(
            tensor(view, "depth"), tensor(view, "rgb"), tensor(view, "norm"),
            args.family, args.method, depth_full=tensor(view, "depth_full"),
            rgb_full=tensor(view, "rgb_full"))
        return pc, val, col

    for i in range(start, min(len(source), args.maxIter)):
        item = source[i]
        T_gt = torch.as_tensor(np.asarray(item["T_gt"]), dtype=torch.float32,
                               device=device)[None]
        pc_s, val_s, col_s = parse(item["data_s"])
        pc_t, val_t, col_t = parse(item["data_t"])
        vs, vt = val_s[0].cpu().numpy(), val_t[0].cpu().numpy()
        ps = pc_s[0].cpu().numpy()[vs]
        pt = pc_t[0].cpu().numpy()[vt]
        ov = None
        ov_path = ov_key(i) if ov_cache_dir else None
        if ov_path and os.path.exists(ov_path):
            with np.load(ov_path) as z:
                ov = {k: float(z[k]) for k in _OV_KEYS}
        if ov is None:
            ov = natreg.overlap_stats(ps, pt, T_gt[0].cpu().numpy())
            if ov_path:
                tmp_p = ov_path + f".tmp{os.getpid()}"
                np.savez(tmp_p, **ov)
                os.replace(tmp_p + ".npz", ov_path)
        if float(ov["overlap"]) < 0.1:   # the original evaluation's skip
            continue
        cs = col_s[0].cpu().numpy()[vs]
        ct = col_t[0].cpu().numpy()[vt]
        T_hat = np.asarray(method(ps, pt, cs, ct), np.float32)
        errs = harness.pose_errors(
            torch.as_tensor(T_hat, device=device)[None], T_gt, pc_s, val_s)
        runner.record({
            **{k: float(ov[k]) for k in _OV_KEYS}, "pair_idx": i,
            **{k: float(v[0]) for k, v in errs.items()}, "T_hat": T_hat})
    runner.save()
    runner.print_stats()
    return runner
