"""Reference pose errors of the JAX package with the shipped trained
completion nets, on the 16 held-out synthetic pairs that the port's
`cli.evaluate --dataList synthetic --maxIter 16` reads (`chip_smoke.py`
phase 5g).

    JAX_PLATFORMS=cpu python tools/trained_reference.py \
        [--datasets suncg scannet] [--key_offsets 0 1 2] [--bf16 1]

The configuration is the JAX evaluate CLI's: method `ours` (3 steps), the
CLI's default sigmas and `KeypointConfig()` (C = 1720), SCNet at ngf 64
with `--comp_ckpt relativepose_tpu/data/pretrained/<dataset>.comp.npz`,
bf16 compute unless `--bf16 0`, 4 pairs per jitted call (the CLI's
default `--batch_pairs`), the pairs of `SyntheticPairs(<dataset>, n=16,
seed=20_000)`.  The CLI draws the keypoints of batch i from
`fold_in(fold_in(PRNGKey(seed), 0), i)` with seed 0; here `seed` is each
key offset in turn, so the spread of the medians over the offsets is how
far the keypoint draws alone move them.  The port draws its keypoints
from torch generators, so its medians are compared with these within
that spread, not exactly.

For each dataset and offset it prints the per-pair rotation (degrees)
and translation errors with the pair's overlap, the mean per overlap
bucket, and one JSON line with the medians; last, per dataset, one JSON
line with the medians' spread (largest minus smallest) over the offsets.
Runs on the CPU: one compile per dataset (a few minutes), then about
half a minute per pair.

With `--out FILE` (JSON) it also records, for each key offset, the
keypoint draws the JAX pipeline makes for every pair and step
(`tests/torch_parity.py::jax_pipeline_draws`) and, for each `--bf16`
value, the JAX package's per-pair errors and poses on them.  With
`--port` it then runs the port's evaluation function
(`relativepose_tpu_torch.eval.harness.make_batched_eval_fn`, the port
CLI's configuration) on the CPU in f32 on the same draws, and measures
on pair 0's first completion input (built by the port from the
identity) the relative L2 distance of each SCNet output (the port's
f32, the JAX package's f32 and bf16) from the f64 function (the Flax
module in f64, `tests/torch_parity.py::flax_f64`), and of the JAX
package's bf16 from its f32.  `chip_smoke.py` phase 5g reads the file
and runs the port on the card on the same draws:

    JAX_PLATFORMS=cpu python tools/trained_reference.py \
        --bf16 1 0 --port --out tests/data/trained_reference.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from relativepose_tpu.cli import evaluate as jeval  # noqa: E402
from relativepose_tpu.data import datasets as dsets  # noqa: E402
from relativepose_tpu.eval import harness  # noqa: E402
from relativepose_tpu.match.keypoints import KeypointConfig  # noqa: E402
from relativepose_tpu.match.solver import SolverStaticConfig  # noqa: E402
from relativepose_tpu.pipeline import PipelineConfig  # noqa: E402

N_PAIRS = 16


def checkpoint(dataset):
    return os.path.join(ROOT, "relativepose_tpu", "data", "pretrained",
                        f"{dataset}.comp.npz")


def make_eval(dataset, bf16, workdir):
    """The JAX evaluate CLI's objects for `dataset` (its `main` up to the
    stream) -> (args, cfg, eval_fn)."""
    args = jeval._parse_args([
        "--dataList", "synthetic", "--synthetic_family", dataset,
        "--method", "ours", "--maxIter", str(N_PAIRS), "--comp_ckpt",
        checkpoint(dataset), "--bf16", str(bf16), "--rm", "--exp",
        f"trained_{dataset}"])
    sigma_table = np.tile([args.sigmaAngle1, args.sigmaAngle2,
                           args.sigmaDist, args.sigmaFeat], (3, 1))
    cfg = harness.EvalConfig(
        dataset=args.family, method=args.method, exp=args.exp,
        out_dir=os.path.join(workdir, "rpe"), max_iter=args.maxIter,
        batch_pairs=args.batch_pairs, resume=False, sigma_table=sigma_table,
        save_every=10 ** 9)
    pipe_cfg = PipelineConfig(
        dataset=args.family, mask_method=args.maskMethod,
        alter_steps=cfg.alter_steps, completion=cfg.completion,
        output_type=args.outputType, snumclass=args.snumclass,
        step_select=args.step_select, min_score=args.min_score,
        solver=SolverStaticConfig(), feature_dim=args.featureDim,
        keypoints=KeypointConfig())
    factory, params = jeval.scnet_fn_factory_from_checkpoint(
        args, pipe_cfg.layout)
    run = jax.jit(harness.make_batched_eval_fn(factory, cfg, pipe_cfg))
    hp = harness.hyper_params_from_table(sigma_table,
                                         alter_steps=cfg.alter_steps)

    def eval_fn(data_s, data_t, T_gt, keys):
        return run(data_s, data_t, T_gt, keys, params, hp)

    scnet = jax.jit(jax.vmap(factory(None, None, params)))
    return args, pipe_cfg, cfg, eval_fn, scnet


def batch_keys(seed, bi, n):
    """The keys `relativepose_tpu.eval.harness.evaluate_stream` hands
    batch bi of n pairs (first repeat)."""
    rep_key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    return jax.random.split(jax.random.fold_in(rep_key, bi), n)


def jax_draws(source, args, pipe_cfg, seed):
    """Per pair, per step, the keypoint draws of the JAX pipeline as
    dicts of lists."""
    import jax.numpy as jnp
    from torch_parity import jax_detection_mask, jax_pipeline_draws
    out = []
    for bi, (ds, dt, T_gt, n) in enumerate(dsets.batched(
            source, args.batch_pairs, max_items=N_PAIRS)):
        keys = batch_keys(seed, bi, T_gt.shape[0])
        det = [np.stack([jax_detection_mask(
            {k: jnp.asarray(v[b]) for k, v in d.items()}, pipe_cfg)
            for b in range(T_gt.shape[0])]) for d in (ds, dt)]
        steps = jax_pipeline_draws(keys, pipe_cfg.alter_steps, det[0],
                                   det[1], pipe_cfg.keypoints,
                                   pipe_cfg.mask_method)
        for b in range(n):
            out.append([{k: getattr(d, k)[b].numpy().tolist()
                         for k in ("sel_t1", "sel_s", "rnd_u", "sel_t2")}
                        for d in steps])
    return out


def stack_draws(draws, idx, device="cpu"):
    """Draws of pairs idx (from `jax_draws` or the JSON file) -> per step
    `KeypointDraws` of [len(idx), ...] tensors."""
    import torch
    from relativepose_tpu_torch.match.keypoints import KeypointDraws
    types = dict(sel_t1=torch.int64, sel_s=torch.int64,
                 rnd_u=torch.float32, sel_t2=torch.int64)
    return [KeypointDraws(**{k: torch.tensor([draws[i][s][k] for i in idx],
                                             dtype=t, device=device)
                             for k, t in types.items()})
            for s in range(len(draws[idx[0]]))]


def run_port_f32(dataset, source, args, draws):
    """The port's evaluation on the CPU in f32 on the JAX draws -> (per
    pair rotation and translation errors, pair 0's first completion
    input [1, 2, H, W, 16] and the port's output on it)."""
    import torch
    from relativepose_tpu_torch.cli import evaluate as tev
    from relativepose_tpu_torch.eval import harness as th
    targs = tev._parse_args([
        "--dataList", "synthetic", "--synthetic_family", dataset,
        "--method", "ours", "--maxIter", str(N_PAIRS), "--comp_ckpt",
        checkpoint(dataset), "--bf16", "0", "--device", "cpu", "--rm"])
    cfg = tev.eval_config(targs)
    pcfg = tev.pipeline_config(targs, cfg)
    factory, params = tev.scnet_fn_factory_from_checkpoint(targs,
                                                           pcfg.layout)
    seen = []

    def spied(ds, dt, p):
        fn = factory(ds, dt, p)

        def scnet_fn(x):
            y = fn(x)
            if not seen:
                seen.append((x[:1].clone(), y[:1].clone()))
            return y
        return scnet_fn

    run = th.make_batched_eval_fn(spied, cfg, pcfg, "cpu")
    hp = th.hyper_params_from_table(cfg.sigma_table,
                                    alter_steps=cfg.alter_steps)
    rot, trans, i = [], [], 0
    for ds, dt, T_gt, n in dsets.batched(source, args.batch_pairs,
                                         max_items=N_PAIRS):
        idx = list(range(i, i + T_gt.shape[0]))
        out = run(ds, dt, T_gt, 0, params, hp,
                  draws=stack_draws(draws, idx))
        rot += [float(v) for v in out["err_ad"][:n]]
        trans += [float(v) for v in out["err_t"][:n]]
        i += n
    x, y = seen[0]
    return rot, trans, x.numpy(), y.numpy()


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def pano_distances(dataset, x, y, scnets):
    """Relative L2 distances of pair 0's first completed pano: the port's
    f32 `y` and the JAX package's f32 and bf16 outputs on the input `x`,
    each from the f64 function, and the JAX bf16 from the JAX f32."""
    from relativepose_tpu.models import SCNet
    from relativepose_tpu.utils.checkpoint import load_params_npz
    from torch_parity import flax_f64
    ys = {b: np.asarray(f(x), np.float64) for b, f in scnets.items()}
    y64 = flax_f64(SCNet(ngf=64, snumclass=config_snumclass(dataset)),
                   load_params_npz(checkpoint(dataset)), x[0])[None]
    out = {"pair": 0, "shape": list(y.shape),
           "port_f32_vs_f64": rel_l2(y, y64)}
    if 0 in ys:
        out["jax_f32_vs_f64"] = rel_l2(ys[0], y64)
    if 1 in ys:
        out["jax_bf16_vs_f64"] = rel_l2(ys[1], y64)
    if 0 in ys and 1 in ys:
        out["jax_bf16_vs_jax_f32"] = rel_l2(ys[1], ys[0])
    return out


def config_snumclass(dataset):
    from relativepose_tpu import config
    return config.NUM_CLASSES[dataset]


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--datasets", nargs="+", default=["suncg", "scannet"])
    p.add_argument("--key_offsets", nargs="+", type=int, default=[0, 1, 2])
    p.add_argument("--bf16", nargs="+", type=int, default=[1])
    p.add_argument("--out", default=None,
                   help="JSON file of each key offset's draws and per-pair "
                        "results")
    p.add_argument("--port", action="store_true",
                   help="with --out: run the port on the CPU in f32 on the "
                        "same draws")
    p.add_argument("--workdir", default=os.path.join(ROOT, "tmp",
                                                     "trained_reference"))
    a = p.parse_args()
    jax.config.update("jax_platforms", "cpu")
    record = {"tool": "tools/trained_reference.py", "pairs": N_PAIRS,
              "key_offsets": a.key_offsets, "datasets": {}}
    for dataset in a.datasets:
        rec = record["datasets"][dataset] = {"runs": {}}
        scnets = {}
        for bf16 in a.bf16:
            args, pipe_cfg, cfg, eval_fn, scnets[bf16] = make_eval(
                dataset, bf16, a.workdir)
            source = dsets.SyntheticPairs(args.family, n=N_PAIRS,
                                          seed=args.eval_seed,
                                          ramp_weight=args.ramp_weight,
                                          n_clutter=args.n_clutter)
            medians = {}
            for off in a.key_offsets:
                t0 = time.time()
                runner = harness.evaluate_stream(
                    lambda: dsets.batched(source, args.batch_pairs,
                                          max_items=N_PAIRS),
                    eval_fn, cfg, seed=off)
                rows = runner.error_stats
                if len(rows) != N_PAIRS:
                    raise RuntimeError(f"{dataset}: {len(rows)} result rows")
                rot = np.array([float(r["err_ad"]) for r in rows])
                trans = np.array([float(r["err_t"]) for r in rows])
                for i, r in enumerate(rows):
                    print(f"{dataset} bf16 {bf16} key_offset {off} pair {i}: "
                          f"overlap {float(r['overlap']):.4f} rotation "
                          f"{rot[i]:.4f} deg translation {trans[i]:.4f}",
                          flush=True)
                runner.print_stats()
                medians[off] = (float(np.median(rot)),
                                float(np.median(trans)))
                summary = {k: v for k, v in runner.summary().items()
                           if k.startswith(("rot_0", "trans_0"))}
                print(json.dumps({
                    "dataset": dataset, "bf16": bf16, "key_offset": off,
                    "pairs": N_PAIRS, "rot_median_deg": medians[off][0],
                    "trans_median": medians[off][1], "buckets": summary,
                    "seconds": time.time() - t0}), flush=True)
                rec["overlap"] = [float(r["overlap"]) for r in rows]
                rec["runs"].setdefault(str(off), {})[
                    "jax_bf16" if bf16 else "jax_f32"] = {
                    "rot_deg": rot.tolist(), "trans": trans.tolist(),
                    "T_hat": [np.asarray(r["T_hat"]).tolist()
                              for r in rows]}
            rots = [m[0] for m in medians.values()]
            trs = [m[1] for m in medians.values()]
            print(json.dumps({
                "dataset": dataset, "bf16": bf16,
                "key_offsets": a.key_offsets, "rot_medians_deg": rots,
                "rot_median_spread_deg": max(rots) - min(rots),
                "trans_medians": trs,
                "trans_median_spread": max(trs) - min(trs)}), flush=True)
        if not a.out:
            continue
        for off in a.key_offsets:
            run = rec["runs"][str(off)]
            run["draws"] = jax_draws(source, args, pipe_cfg, off)
            if not a.port:
                continue
            rot, trans, x, y = run_port_f32(dataset, source, args,
                                            run["draws"])
            run["port_cpu_f32"] = {"rot_deg": rot, "trans": trans}
            print(f"{dataset} key_offset {off} port f32 on the CPU, JAX "
                  f"draws: per pair {np.round(rot, 3).tolist()}; median "
                  f"rotation {np.median(rot):.4f} deg, translation "
                  f"{np.median(trans):.4f}", flush=True)
        if a.port:
            pano = pano_distances(dataset, x, y, scnets)
            rec["pano_rel_l2"] = pano
            print(f"{dataset} pair 0, first completion input: relative L2 "
                  f"{json.dumps(pano)}", flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(record, f, separators=(",", ":"))
        print(f"wrote {a.out}", flush=True)


if __name__ == "__main__":
    main()
