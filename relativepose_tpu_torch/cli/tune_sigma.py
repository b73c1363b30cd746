"""Sigma tuning driver (`tune/sigma.py`), with the flags of
`relativepose_tpu.cli.tune_sigma` plus `--device`.

Caches the matching primitives of every recurrence level by running the
recurrent pipeline over the pairs (oracle completion, or SCNet with
`--comp_ckpt`: npz weights or a checkpoint manager directory), then
fits the 4 matching sigmas per level and writes a sigma table in the
format of `data/params/final_param_*_rlevel_3.txt`:
    python -m relativepose_tpu_torch.cli.tune_sigma --dataList synthetic \\
        --synthetic_family suncg --num_pairs 20 --rlevel 3 \\
        --out experiments/sigma_suncg.txt

`--tune_method grad` differentiates the solver, so its objective uses the
plain W build; `fd` runs the pair-weight CUDA kernel in every objective
evaluation, as the JAX driver runs the Pallas kernel.  A cache written by
either package (`--cache x.npy`) loads in the other.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from relativepose_tpu_torch import config
from relativepose_tpu_torch.cli import common
from relativepose_tpu_torch.data import datasets as dsets
from relativepose_tpu_torch.match.keypoints import KeypointConfig
from relativepose_tpu_torch.match.solver import (
    SolverHyperParams,
    SolverStaticConfig,
)
from relativepose_tpu_torch.pipeline import PipelineConfig
from relativepose_tpu_torch.tune import sigma as st

CACHE_BATCH = 16   # pairs per pipeline call while caching


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataList", type=str, default="synthetic")
    p.add_argument("--listPath", type=str, default=None)
    p.add_argument("--synthetic_family", type=str, default="suncg")
    p.add_argument("--num_pairs", type=int, default=30)
    p.add_argument("--rlevel", type=int, default=3)
    p.add_argument("--max_iter", type=int, default=30)
    p.add_argument("--outputType", type=str, default="rgbdnsf")
    p.add_argument("--featureDim", type=int, default=32)
    p.add_argument("--comp_ckpt", type=str, default=None,
                   help="completion weights: an npz weight file or a "
                        "checkpoint manager directory (oracle "
                        "completion without one)")
    p.add_argument("--ngf", type=int, default=64,
                   help="SCNet width (must match the checkpoint)")
    p.add_argument("--skipLayer", type=int, default=1)
    p.add_argument("--batchnorm", type=int, default=1)
    p.add_argument("--cache", type=str, default=None,
                   help="primitive cache .npy (created if missing)")
    p.add_argument("--tune_method", type=str, default="grad",
                   choices=["grad", "fd"],
                   help="'grad' = exact-gradient Adam on log-sigma; 'fd' = "
                        "the original's randomized finite differences")
    p.add_argument("--val_frac", type=float, default=0.25,
                   help="held-out pair fraction per level; tuned rows are "
                        "kept only if they beat the defaults there")
    p.add_argument("--grad_steps", type=int, default=150)
    p.add_argument("--grad_lr", type=float, default=0.03)
    p.add_argument("--out", type=str, required=True,
                   help="output sigma table txt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scene_seed", type=int, default=0,
                   help="synthetic scene seed for the tuning pairs")
    p.add_argument("--ramp_weight", type=float, default=0.35,
                   help="synthetic scene knob (see cli.common)")
    p.add_argument("--n_clutter", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the [rlevel, 4] sigma table it wrote."""
    args = _parse_args(argv)
    device = common.resolve_device(args)
    family = (args.synthetic_family if "synthetic" in args.dataList
              else config.canonical_dataset(args.dataList))
    pipe_cfg = PipelineConfig(
        dataset=family,
        mask_method="kinect" if family == "scannet" else "second",
        alter_steps=args.rlevel, snumclass=config.NUM_CLASSES[family],
        feature_dim=args.featureDim, output_type=args.outputType,
        keypoints=KeypointConfig())

    if args.cache and os.path.exists(args.cache):
        blob = np.load(args.cache, allow_pickle=True).item()
        by_level, rgt = blob["primitives"], blob["R_gt"]
        print(f"loaded primitive cache {args.cache}")
    else:
        from relativepose_tpu_torch.cli.evaluate import (
            scnet_fn_factory_from_checkpoint,
        )
        args.snumclass = pipe_cfg.snumclass
        args.useTanh = 1
        args.bf16 = 1
        args.internal_size = "224x224"
        args.torch_comp_ckpt = None
        factory, scnet_params = scnet_fn_factory_from_checkpoint(
            args, pipe_cfg.layout)
        if "synthetic" in args.dataList:
            source = dsets.SyntheticPairs(
                family, n=args.num_pairs, seed=args.scene_seed,
                ramp_weight=args.ramp_weight, n_clutter=args.n_clutter)
        else:
            source = dsets.PanoPairDataset(family, "train", args.listPath)
        by_level, rgt = st.cache_primitives(
            factory, dsets.batched(source, min(CACHE_BATCH, args.num_pairs),
                                   max_items=args.num_pairs),
            SolverHyperParams(), pipe_cfg,
            generator=torch.Generator(device=device).manual_seed(args.seed),
            cache_path=args.cache, scnet_params=scnet_params, device=device)
        print(f"cached primitives for {len(by_level[0])} pairs x "
              f"{len(by_level)} levels")

    # the exact-gradient path differentiates the solver, and the CUDA
    # pair-weight kernel has no backward: its objective uses the plain W
    # build
    solver_cfg = SolverStaticConfig(
        pallas_w_build=args.tune_method != "grad", use_pallas=False)
    table = st.tune_per_level(
        by_level, rgt, fd=st.FDConfig(max_iter=args.max_iter, seed=args.seed),
        cfg=solver_cfg, method=args.tune_method, val_frac=args.val_frac,
        grad_steps=args.grad_steps, grad_lr=args.grad_lr, device=device)
    np.savetxt(args.out, table)
    print(f"wrote sigma table {args.out}:\n{table}")
    return table


if __name__ == "__main__":
    main()
