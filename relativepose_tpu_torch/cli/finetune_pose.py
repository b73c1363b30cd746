"""Fine-tune a trained SCNet with the end-to-end pose loss, through the
whole complete -> match -> solve recurrence (`train/finetune_pose.py`).

The flags of `relativepose_tpu.cli.finetune_pose`, plus `--device`:
    python -m relativepose_tpu_torch.cli.finetune_pose --exp comp_ft \\
        --comp_ckpt experiments/exp_comp_suncg/params \\
        --synthetic_family suncg --steps 400 --batch_pairs 4 --rm

On the CPU at a small width: `--device cpu --bf16 0 --ngf 8` and a
checkpoint of that width.  `--comp_ckpt` takes the checkpoint manager
directory of the completion CLI of either package (its newest checkpoint,
`utils/checkpoint.py::restore_params`) or an npz weight file.  Writes the
orbax `checkpoint_%04d/` that the JAX package's driver writes ({'params':
SCNet's tree, 'step'}) to experiments/exp_<exp>/params, which
`cli.evaluate --comp_ckpt` of either package reads.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from relativepose_tpu_torch import config
from relativepose_tpu_torch.cli import common
from relativepose_tpu_torch.core import overlap as overlap_mod
from relativepose_tpu_torch.data import datasets as dsets
from relativepose_tpu_torch.data.device_store import DeviceStore
from relativepose_tpu_torch.eval import harness
from relativepose_tpu_torch.match.keypoints import KeypointConfig
from relativepose_tpu_torch.match.solver import SolverStaticConfig
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.models.scnet import SCNet
from relativepose_tpu_torch.pipeline import PipelineConfig
from relativepose_tpu_torch.train import finetune_pose
from relativepose_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    restore_params,
)
from relativepose_tpu_torch.utils.experiment import ExperimentDirs
from relativepose_tpu_torch.utils.log import FileLogger

OVERLAP_BATCH = 64


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp", type=str, required=True)
    p.add_argument("--comp_ckpt", type=str, required=True,
                   help="completion weights: a checkpoint manager "
                        "directory (experiments/exp_<name>/params, its "
                        "newest checkpoint), or an npz weight file")
    p.add_argument("--synthetic_family", type=str, default="suncg")
    p.add_argument("--synthetic_n", type=int, default=1024)
    p.add_argument("--view_detail_jitter", type=int, default=1)
    p.add_argument("--ramp_weight", type=float, default=0.35,
                   help="synthetic scene knob (see cli.common)")
    p.add_argument("--n_clutter", type=int, default=0)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch_pairs", type=int, default=4)
    p.add_argument("--alter_steps", type=int, default=2,
                   help="recurrence depth while fine-tuning (the eval "
                        "runs 3; the per-step sigma table still applies)")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--refit", type=int, default=0,
                   help="solver inlier-refit rounds (see cli.evaluate "
                        "--refit)")
    p.add_argument("--rot_weight", type=float, default=1.0)
    p.add_argument("--trans_weight", type=float, default=0.25)
    p.add_argument("--anchor_weight", type=float, default=0.0)
    p.add_argument("--max_overlap", type=float, default=0.55,
                   help="train only on pairs at or below this point-cloud "
                        "overlap")
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--bf16", type=int, default=1)
    p.add_argument("--save_every", type=int, default=100)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--rm", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, or cpu)")
    return p.parse_args(argv)


def pair_overlaps(store: DeviceStore, family: str):
    """Point-cloud overlap of every stored pair under its ground-truth
    pose, in batches of OVERLAP_BATCH -> numpy [n]."""
    dev = store.arrays["rgb"].device
    ovs = []
    with torch.no_grad():
        for lo in range(0, store.n, OVERLAP_BATCH):
            idx = torch.arange(lo, min(lo + OVERLAP_BATCH, store.n),
                               device=dev)
            ds, dt, T_gt = finetune_pose.gather_eval_pairs(store.arrays, idx)
            pc_s, val_s, _ = harness.parse_eval_data(
                ds["depth"], ds["rgb"], ds["norm"], family, "ours")
            pc_t, val_t, _ = harness.parse_eval_data(
                dt["depth"], dt["rgb"], dt["norm"], family, "ours")
            ovs.append(overlap_mod.point_cloud_overlap(
                pc_s, val_s, pc_t, val_t, T_gt)["overlap"].cpu().numpy())
    return np.concatenate(ovs)


def main(argv=None):
    """Returns the path of the last checkpoint (its `checkpoint_%04d/`)."""
    args = _parse_args(argv)
    device = common.resolve_device(args)
    dirs = ExperimentDirs(args.exp, rm=args.rm, resume=not args.rm)
    logf = FileLogger(dirs.log_path)
    family = args.synthetic_family

    pipe_cfg = PipelineConfig(
        dataset=family, alter_steps=args.alter_steps, completion=True,
        mask_method="kinect" if family == "scannet" else "second",
        snumclass=config.NUM_CLASSES[family], keypoints=KeypointConfig(),
        remat=True,
        # both CUDA kernels have no backward: the differentiable path uses
        # the plain W build and the plain power iteration
        solver=SolverStaticConfig(pallas_w_build=False, use_pallas=False,
                                  refit_rounds=args.refit))
    hp = harness.hyper_params_from_table(
        harness.default_sigma_table(family)[:args.alter_steps],
        alter_steps=args.alter_steps)
    ft_cfg = finetune_pose.PoseFinetuneConfig(
        learning_rate=args.lr, rot_weight=args.rot_weight,
        trans_weight=args.trans_weight, anchor_weight=args.anchor_weight,
        ngf=args.ngf, dtype=torch.bfloat16 if args.bf16 else None)

    net = SCNet(output_type=pipe_cfg.output_type,
                snumclass=pipe_cfg.snumclass,
                feature_dim=pipe_cfg.feature_dim, ngf=args.ngf,
                dtype=ft_cfg.dtype)
    convert.load_flax_params(net, restore_params(args.comp_ckpt)["params"])
    state = finetune_pose.init_state(net.to(device), ft_cfg)

    # device-resident low-overlap training pairs
    src = dsets.SyntheticPairs(
        family, n=args.synthetic_n, seed=0,
        view_detail_jitter=bool(args.view_detail_jitter),
        ramp_weight=args.ramp_weight, n_clutter=args.n_clutter)
    store = DeviceStore(src, log=logf, device=device)
    ovs = pair_overlaps(store, family)
    keep = np.where(ovs <= args.max_overlap)[0].astype(np.int64)
    logf(f"{len(keep)}/{store.n} pairs at overlap <= {args.max_overlap} "
         f"(median kept overlap {np.median(ovs[keep]):.3f})")

    step_fn = finetune_pose.make_finetune_step(pipe_cfg, hp, ft_cfg)
    ckpt = CheckpointManager(dirs.params_dir, keep=3)
    rng = np.random.RandomState(0)
    gen = torch.Generator(device=device).manual_seed(42)
    path = None
    t0 = time.time()
    for it in range(args.steps):
        idx = torch.from_numpy(rng.choice(keep, size=args.batch_pairs,
                                          replace=False)).to(device)
        data_s, data_t, T_gt = finetune_pose.gather_eval_pairs(store.arrays,
                                                               idx)
        metrics = step_fn(state, data_s, data_t, T_gt, generator=gen)
        if (it + 1) % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            logf(f"step {it + 1}/{args.steps} loss {m['loss']:.4f} "
                 f"rotF2 {m['rot_frob2']:.4f} trans {m['trans_se']:.4f} "
                 f"gnorm {m['grad_norm']:.3f} "
                 f"({(time.time() - t0) / (it + 1):.2f} s/step)")
        if (it + 1) % args.save_every == 0 or it + 1 == args.steps:
            path = ckpt.save(it + 1, {
                "params": state.params_tree(),
                "step": np.asarray(state.step, np.int32)})
            logf(f"step {it + 1}: checkpoint saved")
    return path


if __name__ == "__main__":
    main()
