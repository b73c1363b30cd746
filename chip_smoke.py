#!/usr/bin/env python3
"""Chip smoke run of relativepose_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each ending with one line that gives its own seconds:
  1. device: torch and CUDA versions, the card's name and power limit;
  2. build: both CUDA kernels with nvcc (in parallel), with the
     registers / shared memory that `-Xptxas -v` reports and the size of
     each kernel's largest loop in machine instructions;
  3. the pair-weight kernel against its plain PyTorch version at B=16,
     C=1720 and at the ragged edges B in {1, 3}, C in {1, 5, 63, 64, 65,
     1722}: W within 5e-5, counts within 2, W bitwise symmetric, zero
     diagonal, two launches bitwise equal; CUDA-event times of the
     kernel's launch alone (packed inputs and outputs allocated once), of
     the whole wrapper and of the plain version;
  4. the power-iteration kernel against its plain version at the same
     shapes, 30 iterations: per-pair eigenvector cosine >= 1 - 1e-4, two
     launches bitwise equal, v kept at 1 when h = 0; its cluster size;
     times of its launch, its wrapper, the plain version and a torch.bmm
     loop (the library yardstick, never used by the port);
  5. the flagship pipeline (3 steps, suncg 160x640, 1720 correspondences,
     irls+sm with 30 power iterations, full-width bf16 SCNet with weights
     from a fixed seed) on 16 synthetic pairs, with the pair-weight kernel
     and then with both kernels: finite [16, 4, 4] poses, orthonormal R,
     each kernel launched; pairs/s over 3 timed calls; the same with
     ground-truth (oracle) completion, whose median rotation error must
     stay under 5 degrees, as the JAX package's end-to-end test requires;
  5c. the same on 16 synthetic ScanNet pairs (the kinect window, DoG on the
     480x640 frames, a 21-class SCNet): pairs/s, launches, and an oracle
     median rotation error at most 2 degrees above the JAX package's on
     the same pairs (`tools/scannet_oracle_reference.py`, in PERF.md);
  5d. the options on the suncg pairs with oracle completion and both
     kernels: 3 refit and 3 trans-refine rounds and 5 ICP iterations per
     step, at icp_dof 6 and 3: finite orthonormal poses, median rotation
     error under 5 degrees, the median translation error beside 5b's;
  5e. the evaluation CLI in this process (`cli.evaluate.main`, 16 pairs in
     one batch, oracle completion): ours on suncg and scannet, ours_nr on
     matterport; a 16-row result file, every summary value finite or
     None, the suncg median rotation error under 5 degrees; the driver
     prints each summary JSON on a line of its own;
  5g. the evaluation CLI with the shipped trained completion nets
     (`--comp_ckpt relativepose_tpu/data/pretrained/suncg.comp.npz`, then
     `scannet.comp.npz`; full width, bf16) on 5e's 16 pairs in one call:
     finite summaries, orthonormal poses, 3 launches of K1, the bucket
     means and medians beside the JAX package's on the same pairs
     (`tools/trained_reference.py`), its pairs/s; then the CLI's
     evaluation function on the JAX package's keypoint draws of those
     pairs in bf16 and in f32, whose median rotation error may be at most
     max(2 degrees, the JAX package's draw-seed spread) above the JAX
     package's on the same draws, and the completed pano of one pair in
     bf16 and f32 on the card against f32 on the CPU; the seconds to load
     and convert a net; a missing npz fails the phase;
  6a. the two training steps at full width (batch 8 pairs, bf16 compute
     with f32 parameters, Resnet18_8s at width 64, SCNet at ngf 64 with
     internal 224x224 and its frozen netF teacher) on 16 synthetic suncg
     pairs resident on the card: ms per step by CUDA events (5 steps
     after one warm-up), pairs/s, peak device memory, and the split
     between the augmentation (`gather_batch`) and forward + backward +
     Adam, each timed alone; every loss and gradient norm finite, and 20
     steps on one fixed batch must leave the loss below its first value;
  6b. both training CLIs in this process at their defaults (full width,
     batch 8, bf16): `cli.train_feature` on the synthetic debug set for
     6 s, then `cli.train_completion --featurelearning 1 --feat_ckpt` the
     params directory the feature run just wrote; each must write its
     orbax checkpoint (the JAX trainers' state tree) and log only finite
     losses; then the completion checkpoint restored into a full-width
     completion state on the card, that state written again by the
     port's manager (bytes, seconds and MB/s on the card's host) and read
     back with every leaf's sha256 as in memory;
  6c. pose fine-tuning through the pipeline at the fine-tuning CLI's
     defaults (SCNet from 6b's params directory at ngf 64, bf16 compute
     with f32 parameters, batch 4 pairs, 2 recurrence steps with remat,
     the full keypoint budget, irls+sm with 30 power iterations and the
     per-step sigma table, both kernels off): first one forward+backward with
     remat and one without on the same draws (equal losses, gradient
     norms within 1e-3, cosine >= 0.9999, remat's peak memory the lower),
     then 1 warm-up step and 1 step timed by CUDA events beside the host
     time to enqueue a step: ms per step, pairs/s, peak device memory,
     finite losses and a positive gradient norm, no kernel launched; then
     `cli.finetune_pose.main` (8 synthetic pairs, at least 4 kept by the
     overlap filter, 1 step) whose params directory, read by the
     evaluation CLI's loader, must give finite orthonormal poses on 5b's
     pairs;
  6d. sigma tuning: `cli.tune_sigma.main` on 8 pairs, 3 levels, SCNet
     from 6c's params directory, first by finite differences (1
     iteration; K1 in every objective evaluation), then by exact-gradient
     Adam (1 step) on the
     same primitive cache: finite positive [3, 4] tables; the level-0
     objective with K1 within 1e-4 of the plain W build at two sigmas;
     seconds per objective evaluation (K1) and per value-and-gradient step
     (plain W);
  7a. the classical baselines: `cli.evaluate.main` with gs, fgs, cgs and
     super4pcs (RPTPU_S4PCS_BUDGET set to 3 s here; the default is 240) on
     4 synthetic suncg pairs, of which 2 pass the 0.1 overlap skip: finite
     orthonormal poses, host seconds per recorded pair, the median
     rotation error, the native library's g++ build time;
  7b. original-repository checkpoints: a seeded full-width SCNet written
     as a `.pth.tar` (reference names, `module.` prefixes, under
     `state_dict`; the inverse map lives in this script) must import back
     within 1e-6 and drive `cli.evaluate --torch_comp_ckpt` (bf16, K1
     counted) to finite orthonormal poses; a seeded feature net written
     the same way drives `cli.train_completion --torch_feat_ckpt` for 2 s
     to its orbax checkpoint;
  7c. one full-width completion step (ngf 64, batch 8, bf16) through
     `train/mesh.py` on a 1-rank NCCL group against the same step without
     a group (one card cannot show a collective across cards; the CPU
     tests with gloo hold 2 and 2 x 2 ranks to the 1-rank step);
  8. the JAX package's orbax checkpoints, read without JAX: the zstd
     decoder built with g++; the committed fixture `tests/data/
     orbax_scnet/` (a seeded SCNet at ngf 2, written by the JAX package's
     CheckpointManager) read with every leaf's sha256 as
     `tests/data/orbax_scnet.json` records it; the decoder's MB/s over the
     fixture's chunks, repeated to 200 MB; `cli.evaluate --comp_ckpt
     tests/data/orbax_scnet --ngf 2` on 4 suncg pairs in one call: K1
     launched 3 times, finite orthonormal poses;
  5f. last, one call of 5b's and one of 5c's first run (K1) and one
     completion step of 6a under torch.profiler (time per stage, the
     device's idle share, the costliest kernels).

Every pipeline phase sets the launch counts to 0 just before it drives the
pipeline and reads them just after; a kernel's `launches` in the JSON line
is the sum over phases 5b-5e, 5g, 6c's evaluation call, 6d, 7b and 8 (the
comparisons of a kernel with its plain version are not counted).  The
training phases 6a and 6b and 6c's fine-tuning steps reach neither
kernel; their counts are printed.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Any failed check raises and
the script exits non-zero.  Without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

BUDGET_S = 900.0          # hard limit for the whole run, build included
B, C, ITERS = 16, 1720, 30
# median oracle rotation error of the JAX package on phase 5c's 16 ScanNet
# pairs (PERF.md section 6, PR 6: tools/scannet_oracle_reference.py on the
# CPU); the port's may be at most 2 degrees above it
JAX_SCANNET_ORACLE_MEDIAN_DEG = 2.5308895
# the JAX package with the shipped trained completion nets on phase 5g's
# 16 held-out pairs per dataset (tools/trained_reference.py on the CPU,
# bf16 SCNet as the JAX evaluate CLI's default, keypoint-draw seeds
# --key_offsets 0 1 2): the median rotation error (degrees) and
# translation error of each seed, and seed 0's bucket means (rotation,
# translation).  Seed 0's draws, the per-pair errors on them in bf16 and
# f32, the port's f32 on the CPU on them and the bf16 SCNet's distance
# from the f32 one are in TRAINED_REFERENCE (the same tool with --out)
JAX_TRAINED = {
    "suncg": dict(rot_medians_deg=[2.2002815, 2.0961119, 1.6190651],
                  trans_medians=[0.4991167, 0.5120081, 0.4689669],
                  buckets={"0-0.1": "2.944 deg, 0.6099",
                           "0.1-0.5": "3.979 deg, 0.3929",
                           "0.5-1.0": "0.759 deg, 0.2594"}),
    "scannet": dict(rot_medians_deg=[7.6728108, 12.1973200, 9.9615459],
                    trans_medians=[1.4628054, 1.3153201, 1.4920003],
                    buckets={"0-0.1": "29.149 deg, 1.6882",
                             "0.1-0.5": "6.322 deg, 1.2996",
                             "0.5-1.0": "8.018 deg, 0.0961"}),
}
TRAINED_REFERENCE = os.path.join("tests", "data", "trained_reference.json")
RAGGED_B, RAGGED_C = (1, 3), (1, 5, 63, 64, 65, 1722)   # tile/cluster edges
# f32 operations per W entry in csrc/pair_weight.cu, counted from its
# source (sqrt, division, exp and arccos one each): 12 for the two edge
# lengths, 6 differences, 9 for d2 and the distance tests, 4 inverse
# lengths, 10 for the normal dots, 24 for the edge-normal dots, 3 x 18 for
# the three angle terms, 3 angle tests, 15 for the weight and the masks
OPS_PER_W_ENTRY = 137
PEAK_F32 = 67e12          # FLOP/s, H100 SXM, outside the tensor cores
PEAK_BYTES = 3.35e12      # B/s, H100 SXM HBM3


class Phases:
    """Prints one line per phase with its seconds; enforces the budget."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def run(self, name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        now = time.perf_counter()
        print(f"[phase] {name}: {now - t:.1f} s "
              f"(total {now - self.t0:.1f} s)", flush=True)
        if now - self.t0 > BUDGET_S:
            raise RuntimeError(f"over the {BUDGET_S:.0f} s budget")
        return out


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps calls, by CUDA events, after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi failed"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    print(card, flush=True)
    return card


def phase_build():
    from relativepose_tpu_torch.ops import kernels
    for k in kernels.build_kernels().values():
        secs = "cached" if k.build_seconds is None else \
            f"{k.build_seconds:.1f} s"
        print(f"built {k.name} ({k.source.name}): {secs}; "
              f"{k.ptxas_info}", flush=True)
        n, ops = largest_loop(k)
        print(f"{k.name}: largest loop {n} machine instructions "
              f"(cuobjdump -sass): {ops}", flush=True)


def largest_loop(kernel):
    """Instruction count and opcode histogram of the largest loop (a
    backward branch and the code it jumps back over) in a built kernel's
    machine code; in the pair-weight kernel that is the body computing one
    entry of W."""
    import collections
    import re
    from relativepose_tpu_torch.ops import kernels
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(kernel._lib_path())],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    ins = []
    for line in sass.splitlines():
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            words = m.group(2).split()
            op = words[1] if words[0].startswith("@") else words[0]
            ins.append((int(m.group(1), 16), op, words[-1]))
    start, end = 0, -1
    for addr, op, target in ins:
        if op == "BRA" and int(target, 16) < addr and \
                addr - int(target, 16) > end - start:
            start, end = int(target, 16), addr
    ops = collections.Counter(op.split(".")[0] for a, op, _ in ins
                              if start <= a <= end)
    return sum(ops.values()), ops.most_common(10)


def kernel_inputs(seed, b, c):
    """Correspondence components at [b, c], from a numpy seed: positions
    in a room-sized box, targets moved by a rigid motion plus noise with a
    fifth of them outliers, unit normals, affinities, the 0.99 marker on
    unobserved ends and some invalid correspondences."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    ps = rng.uniform(-3, 3, (b, c, 3))
    ang = rng.uniform(-np.pi, np.pi, b)
    R = np.zeros((b, 3, 3))
    R[:, 0, 0] = R[:, 2, 2] = np.cos(ang)
    R[:, 0, 2], R[:, 2, 0] = np.sin(ang), -np.sin(ang)
    R[:, 1, 1] = 1.0
    pt = ps @ R.transpose(0, 2, 1) + rng.uniform(-0.5, 0.5, (b, 1, 3))
    pt += 0.02 * rng.randn(b, c, 3)
    out = rng.rand(b, c) < 0.2
    pt[out] = rng.uniform(-3, 3, (int(out.sum()), 3))
    ns = rng.randn(b, c, 3)
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    nt = ns @ R.transpose(0, 2, 1) + 0.05 * rng.randn(b, c, 3)
    nt /= np.linalg.norm(nt, axis=-1, keepdims=True)
    f = rng.rand(b, c)
    w_s = np.where(rng.rand(b, c) > 0.3, 1.0, 0.99)
    w_t = np.where(rng.rand(b, c) > 0.3, 1.0, 0.99)
    cvalid = rng.rand(b, c) > 0.05

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device="cuda")

    return (dev(ps), dev(pt), dev(ns), dev(nt), dev(f), dev(w_s * w_t),
            dev(cvalid, torch.bool))


def power_h(seed, b, c):
    """Spectral-matching h at [b, c]: nonnegative, some entries zero."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    return torch.as_tensor(np.maximum(50.0 - rng.exponential(20.0, (b, c)),
                                      0), dtype=torch.float32, device="cuda")


def check_pair_weight(args, hp):
    """K1 against its plain version on one input: W within 5e-5, counts
    within 2, W bitwise symmetric with a zero diagonal, and two launches
    bitwise equal (W and count partials).  Returns (W, counts, max |W -
    plain|, largest count difference)."""
    import torch
    from relativepose_tpu_torch.ops import kernels
    W, counts = kernels.pair_weight_matrix(*args, hp)
    W0, counts0 = kernels.pair_weight_matrix_plain(*args, hp)
    torch.cuda.synchronize()
    shape = tuple(W.shape)
    err = float((W - W0).abs().max())
    if not err <= 5e-5:
        raise AssertionError(f"pair_weight_matrix {shape}: max |W - plain| "
                             f"{err}")
    dc = max(int((counts[k] - counts0[k]).abs().max()) for k in counts)
    if dc > 2:
        raise AssertionError(f"pair_weight_matrix {shape}: counts off by "
                             f"{dc}")
    if not torch.equal(W, W.transpose(-1, -2)):
        raise AssertionError(f"pair_weight_matrix {shape}: W is not bitwise "
                             "symmetric")
    if bool((torch.diagonal(W, dim1=-2, dim2=-1) != 0).any()):
        raise AssertionError(f"pair_weight_matrix {shape}: nonzero diagonal")
    comps = kernels.pack_components(*args)
    runs = []
    for _ in range(2):
        out = (torch.empty_like(W),
               torch.empty((shape[0], kernels.pair_weight_tiles(shape[1]), 3),
                           dtype=torch.int32, device="cuda"))
        kernels.pair_weight_launch(comps, hp, *out)
        runs.append(out)
    if not (torch.equal(runs[0][0], runs[1][0]) and torch.equal(W, runs[0][0])
            and torch.equal(runs[0][1], runs[1][1])):
        raise AssertionError(f"pair_weight_matrix {shape}: two launches "
                             "differ")
    return W, counts, err, dc


def check_power(W, h):
    """K2 against its plain version on one input: per-pair cosine >=
    1 - 1e-4 and two launches bitwise equal.  Returns (min cosine, max
    |u - plain|)."""
    import torch
    from relativepose_tpu_torch.ops import kernels
    u = kernels.power_iteration(W, h, ITERS)
    u0 = kernels.power_iteration_plain(W, h, ITERS)
    u2 = torch.empty_like(u)
    kernels.power_iteration_launch(W, h, ITERS, u2)
    torch.cuda.synchronize()
    shape = tuple(W.shape)
    cos = torch.nn.functional.cosine_similarity(u, u0, dim=-1)
    if not bool((cos >= 1 - 1e-4).all()):
        raise AssertionError(f"power_iteration {shape}: cosine "
                             f"{cos.min().item()}")
    if not torch.equal(u, u2):
        raise AssertionError(f"power_iteration {shape}: two launches differ")
    return cos.min().item(), float((u - u0).abs().max())


def phase_pair_weight():
    import torch
    from relativepose_tpu_torch.match.solver import SolverHyperParams
    from relativepose_tpu_torch.ops import kernels
    hp = SolverHyperParams()
    errs, dcs = [], []
    for b in RAGGED_B:
        for c in RAGGED_C:
            _, _, err, dc = check_pair_weight(kernel_inputs(2, b, c), hp)
            errs.append(err)
            dcs.append(dc)
    print(f"pair_weight_matrix at B in {RAGGED_B}, C in {RAGGED_C}: max "
          f"|W - plain| {max(errs):.3e}, counts off by at most {max(dcs)}; "
          "bitwise symmetric, zero diagonal, two launches equal", flush=True)

    args = kernel_inputs(0, B, C)
    W, counts, err, dc = check_pair_weight(args, hp)
    comps = kernels.pack_components(*args)
    W1 = torch.empty_like(W)
    parts = torch.empty((B, kernels.pair_weight_tiles(C), 3),
                        dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: kernels.pair_weight_launch(comps, hp, W1, parts), 50)
    wrapper_ms = cuda_ms(lambda: kernels.pair_weight_matrix(*args, hp), 20)
    plain_ms = cuda_ms(lambda: kernels.pair_weight_matrix_plain(*args, hp), 3)
    entries = B * C * (C - 1) / 2   # the least work: one triangle
    t_ops = entries * OPS_PER_W_ENTRY / PEAK_F32
    t_bytes = B * (16 * C * 4 + C * C * 4 + 3 * 4) / PEAK_BYTES
    nonzero = float((W != 0).float().mean())
    print(f"pair_weight_matrix wrapper (pack, allocate, launch, sum the "
          f"partials) B={B} C={C}: {wrapper_ms:.4f} ms", flush=True)
    print(f"pair_weight_matrix B={B} C={C}: max_abs_err {err:.3e}, counts "
          f"off by at most {dc}, counts {[int(counts[k][0]) for k in counts]}"
          f" (pair 0), nonzero share {nonzero:.4f}; launch {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms", flush=True)
    return W, dict(name="pair_weight_matrix", route="cuda",
                   source="relativepose_tpu_torch/csrc/pair_weight.cu",
                   replaces=kernels.PAIR_WEIGHT.replaces, max_abs_err=err,
                   ms=ms, plain_ms=plain_ms,
                   bound_ms=1e3 * max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   library_ms=None)


def phase_power(W):
    import torch
    from relativepose_tpu_torch.match.solver import SolverHyperParams
    from relativepose_tpu_torch.ops import kernels
    info = kernels.power_iteration_info(C)
    print(f"power_iteration: clusters of {info['cluster']} blocks of "
          f"{info['threads']} threads, one per pair; the card runs "
          f"{info['max_active_clusters']} clusters at once at C={C}",
          flush=True)
    hp = SolverHyperParams()
    coss, errs = [], []
    for b in RAGGED_B:
        for c in RAGGED_C:
            Wr, _ = kernels.pair_weight_matrix_plain(*kernel_inputs(3, b, c),
                                                     hp)
            cos, err = check_power(Wr, power_h(4, b, c))
            coss.append(cos)
            errs.append(err)
    u = kernels.power_iteration(Wr, torch.zeros(Wr.shape[:2], device="cuda"),
                                ITERS)
    if not torch.equal(u, torch.ones_like(u)):
        raise AssertionError("power_iteration: h = 0 does not keep v = 1")
    print(f"power_iteration at B in {RAGGED_B}, C in {RAGGED_C}: min cosine "
          f"{min(coss):.7f}, max |u - plain| {max(errs):.3e}, two launches "
          "equal; h = 0 keeps v = 1", flush=True)

    h = power_h(1, B, C)
    cos, err = check_power(W, h)

    def bmm_loop():
        v = torch.ones_like(h)
        for _ in range(ITERS):
            y = torch.bmm(W, torch.stack([v, h * v], dim=-1))
            y = h * y[..., 0] + y[..., 1]
            n = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
            v = torch.where(n > 1e-12, y / n.clamp(min=1e-12), v)
        return v

    u = torch.empty_like(h)
    ms = cuda_ms(lambda: kernels.power_iteration_launch(W, h, ITERS, u), 20)
    wrapper_ms = cuda_ms(lambda: kernels.power_iteration(W, h, ITERS), 20)
    plain_ms = cuda_ms(lambda: kernels.power_iteration_plain(W, h, ITERS), 5)
    library_ms = cuda_ms(bmm_loop, 5)
    t_ops = ITERS * B * (4 * C * C + 6 * C) / PEAK_F32
    t_bytes = B * (C * C + 2 * C) * 4 / PEAK_BYTES
    print(f"power_iteration wrapper (allocate, launch) B={B} C={C}: "
          f"{wrapper_ms:.4f} ms", flush=True)
    w_bytes = ITERS * B * C * C * 4   # W streamed every iteration
    print(f"power_iteration B={B} C={C} iters={ITERS}: min cosine "
          f"{cos:.7f}, max_abs_err {err:.3e}; launch {ms:.4f} ms "
          f"(streaming W every iteration: floor "
          f"{1e3 * w_bytes / PEAK_BYTES:.4f} ms, "
          f"{w_bytes / ms / 1e9:.3f} TB/s), plain {plain_ms:.4f} ms, bmm "
          f"loop {library_ms:.4f} ms", flush=True)
    return dict(name="power_iteration", route="cuda",
                source="relativepose_tpu_torch/csrc/power_iteration.cu",
                replaces=kernels.POWER_ITER.replaces, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=library_ms)


def make_pairs(dataset):
    import numpy as np
    from relativepose_tpu_torch.data import synthetic
    pairs = [synthetic.make_pair(i, dataset, max_baseline=0.5)
             for i in range(B)]

    def stack(v):
        return {k: np.stack([p[v][k] for p in pairs]) for k in pairs[0][v]
                if k != "pose"}

    return stack(0), stack(1), np.stack([p[2] for p in pairs])


def read_counts():
    from relativepose_tpu_torch.ops import kernels
    return {k: v.launches for k, v in kernels.KERNELS.items()}


def add_counts(total, counts):
    for k, n in counts.items():
        total[k] = total.get(k, 0) + n


def pipeline_config(dataset, **kw):
    """The flagship configuration (3 steps, C = 1720, 30 power
    iterations) for one dataset."""
    from relativepose_tpu_torch import config
    from relativepose_tpu_torch.match.keypoints import KeypointConfig
    from relativepose_tpu_torch.match.solver import SolverStaticConfig
    from relativepose_tpu_torch.pipeline import recurrent
    solver = dict(power_iters=30)
    solver.update(kw.pop("solver", {}))
    return recurrent.PipelineConfig(
        dataset=dataset,
        mask_method="kinect" if dataset == "scannet" else "second",
        snumclass=config.NUM_CLASSES[dataset], alter_steps=3,
        keypoints=KeypointConfig(), solver=SolverStaticConfig(**solver),
        **kw)


def drive_scnet(data, card, dataset, launches):
    """The full-width bf16 SCNet pipeline (random weights from
    torch.manual_seed(0)) on the B pairs, with K1 and then with K1+K2:
    1 warm-up and 3 timed calls each; the counts of each run are added to
    `launches`.  Returns (the K1 run's call, its seconds per call)."""
    import torch
    from relativepose_tpu_torch.match.solver import SolverHyperParams
    from relativepose_tpu_torch.models.scnet import SCNet
    from relativepose_tpu_torch.ops import kernels
    from relativepose_tpu_torch.pipeline import recurrent

    data_s, data_t, _ = data
    cfg0 = pipeline_config(dataset)
    torch.manual_seed(0)
    net = SCNet(ngf=64, snumclass=cfg0.snumclass, internal_size=(224, 224),
                dtype=torch.bfloat16).cuda().eval()
    scnet_fn = recurrent.make_scnet_fn(net)
    hp = SolverHyperParams()
    for use_pallas in (False, True):
        cfg = pipeline_config(dataset, solver=dict(use_pallas=use_pallas))
        gen = torch.Generator(device="cuda").manual_seed(7)

        def call(cfg=cfg, gen=gen):
            with torch.no_grad():
                return recurrent.estimate_pose_via_completion(
                    scnet_fn, data_s, data_t, hp, cfg, generator=gen)

        kernels.reset_launch_counts()
        T = call()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            T = call()
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t) / 3
        counts = read_counts()
        add_counts(launches, counts)
        check_poses(T)
        if counts["pair_weight_matrix"] == 0:
            raise AssertionError(f"{dataset} pipeline did not launch "
                                 "pair_weight_matrix")
        if use_pallas and counts["power_iteration"] == 0:
            raise AssertionError(f"{dataset} pipeline did not launch "
                                 "power_iteration")
        print(f"{dataset} pipeline use_pallas={use_pallas}: "
              f"{B / secs:.3f} pairs/s ({secs * 1e3:.1f} ms per call of {B} "
              f"pairs, 3 timed calls after 1 warm-up) launches {counts} on "
              f"{card}", flush=True)
        if not use_pallas:
            profiled = (call, secs)
    return profiled


def oracle_errors(data, cfg, launches=None):
    """Oracle-completion poses of the B pairs under `cfg`, checked finite
    and orthonormal -> (rotation errors deg, translation errors).  With
    `launches`, the counts are set to 0 before and added after."""
    import torch
    from relativepose_tpu_torch.core.rotation import angular_distance
    from relativepose_tpu_torch.match.solver import SolverHyperParams
    from relativepose_tpu_torch.ops import kernels
    from relativepose_tpu_torch.pipeline import recurrent
    from relativepose_tpu_torch.pipeline.oracle import (
        make_oracle_completion_fn,
    )
    data_s, data_t, T_gt = data
    oracle = make_oracle_completion_fn(
        recurrent.as_pair_batch(data_s, "cuda"),
        recurrent.as_pair_batch(data_t, "cuda"), cfg.layout)
    gen = torch.Generator(device="cuda").manual_seed(7)
    kernels.reset_launch_counts()
    with torch.no_grad():
        T = recurrent.estimate_pose_via_completion(
            oracle, data_s, data_t, SolverHyperParams(), cfg, generator=gen)
    torch.cuda.synchronize()
    if launches is not None:
        add_counts(launches, read_counts())
    check_poses(T)
    gt = torch.as_tensor(T_gt, dtype=torch.float32, device="cuda")
    rot = angular_distance(T[:, :3, :3], gt[:, :3, :3]).cpu().numpy()
    trans = torch.linalg.vector_norm(T[:, :3, 3] - gt[:, :3, 3],
                                     dim=-1).cpu().numpy()
    return rot, trans


def phase_pipeline(data, card, launches):
    """5b: the suncg flagship; returns (the profiled call, seconds, the
    K1 oracle's median translation error)."""
    import numpy as np
    profiled = drive_scnet(data, card, "suncg", launches)
    for use_pallas in (False, True):
        rot, trans = oracle_errors(
            data, pipeline_config("suncg", solver=dict(use_pallas=use_pallas)),
            launches)
        print(f"oracle completion use_pallas={use_pallas}: rotation error "
              f"median {np.median(rot):.3f} deg, translation median "
              f"{np.median(trans):.4f}", flush=True)
        if not np.median(rot) < 5.0:
            raise AssertionError(f"oracle rotation errors {rot}")
        if not use_pallas:
            trans_k1 = float(np.median(trans))
    return profiled, trans_k1


def phase_scannet(data, card, launches):
    """5c: the ScanNet path, SCNet timed, then oracle completion against
    the JAX package's median.  Returns the K1 call and its seconds."""
    import numpy as np
    profiled = drive_scnet(data, card, "scannet", launches)
    counts = {}
    rot, trans = oracle_errors(
        data, pipeline_config("scannet", solver=dict(use_pallas=True)),
        counts)
    add_counts(launches, counts)
    limit = JAX_SCANNET_ORACLE_MEDIAN_DEG + 2.0
    print(f"scannet oracle completion (K1+K2, launches {counts}): rotation "
          f"error median {np.median(rot):.3f} deg (limit {limit:.3f}: the "
          f"JAX package's {JAX_SCANNET_ORACLE_MEDIAN_DEG:.3f} + 2), "
          f"translation median {np.median(trans):.4f}; per pair "
          f"{np.round(rot, 3).tolist()}", flush=True)
    if not np.median(rot) <= limit:
        raise AssertionError(f"scannet oracle rotation errors {rot}")
    return profiled


def phase_options(data, trans_5b, launches):
    """5d: refit, trans-refine and ICP on the suncg oracle path."""
    import numpy as np
    for dof in (6, 3):
        counts = {}
        cfg = pipeline_config(
            "suncg", icp_iters=5, icp_dof=dof,
            solver=dict(use_pallas=True, refit_rounds=3,
                        trans_refine_rounds=3))
        rot, trans = oracle_errors(data, cfg, counts)
        add_counts(launches, counts)
        print(f"options refit=3 trans_refine=3 icp=5 icp_dof={dof} (oracle, "
              f"K1+K2, launches {counts}): rotation error median "
              f"{np.median(rot):.3f} deg, translation median "
              f"{np.median(trans):.4f} (5b without options: {trans_5b:.4f})",
              flush=True)
        if counts["pair_weight_matrix"] == 0 or \
                counts["power_iteration"] == 0:
            raise AssertionError(f"options run launched {counts}")
        if not np.median(rot) < 5.0:
            raise AssertionError(f"options rotation errors {rot}")


def phase_evaluate(launches):
    """5e: the evaluation CLI in this process, in a temporary directory."""
    import math
    import shutil
    import tempfile
    import numpy as np
    from relativepose_tpu_torch.cli import evaluate
    from relativepose_tpu_torch.ops import kernels
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        for family, method in (("suncg", "ours"), ("scannet", "ours"),
                               ("matterport", "ours_nr")):
            exp = f"{family}_{method}"
            print(f"evaluate {exp}: {B} pairs, oracle completion; the "
                  "driver's statistics and summary follow", flush=True)
            kernels.reset_launch_counts()
            runner = evaluate.main([
                "--dataList", "synthetic", "--synthetic_family", family,
                "--method", method, "--maxIter", str(B), "--batch_pairs",
                str(B), "--rm", "--exp", exp, "--device", "cuda"])
            counts = read_counts()
            add_counts(launches, counts)
            rows = np.load(os.path.join("tmp", "rpe", exp,
                                        f"{exp}.result.npy"),
                           allow_pickle=True)
            if len(rows) != B:
                raise AssertionError(f"{exp}: {len(rows)} result rows")
            summary = runner.summary()
            bad = {k: v for k, v in summary.items()
                   if v is not None and not math.isfinite(v)}
            if bad:
                raise AssertionError(f"{exp}: summary values {bad}")
            med = float(np.median([float(r["err_ad"]) for r in rows]))
            print(f"evaluate {exp}: median rotation error {med:.3f} deg, "
                  f"launches {counts}", flush=True)
            if family == "suncg" and not med < 5.0:
                raise AssertionError(f"{exp}: median rotation error {med}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)


def trained_draws(draws, device):
    """Per pair, per step draw dicts (`TRAINED_REFERENCE`) -> per step
    `KeypointDraws` of [pairs, ...] tensors on `device`."""
    import torch
    from relativepose_tpu_torch.match.keypoints import KeypointDraws
    types = dict(sel_t1=torch.int64, sel_s=torch.int64,
                 rnd_u=torch.float32, sel_t2=torch.int64)
    return [KeypointDraws(**{k: torch.tensor([d[s][k] for d in draws],
                                             dtype=t, device=device)
                             for k, t in types.items()})
            for s in range(len(draws[0]))]


def rel_l2(a, b):
    import torch
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def phase_trained(card, launches):
    """5g: the shipped trained completion nets (`relativepose_tpu/data/
    pretrained/<dataset>.comp.npz`, full width, method ours, 16 held-out
    pairs in one batch), suncg then ScanNet.

    (a) One `cli.evaluate.main --comp_ckpt ...` call as a user runs it
    (bf16, the CLI's own torch draws): 16 rows, finite summaries,
    orthonormal poses, 3 launches of K1, its bucket means and median
    beside the JAX package's, its pairs/s.  Its draws are not the JAX
    package's, so its median is printed, not compared: over 5 draw seeds
    the port's ScanNet median moved from 7.8 to 20.2 degrees.
    (b) The CLI's evaluation function (`harness.make_batched_eval_fn` on
    the CLI's configuration) on the JAX package's keypoint draws of the
    same pairs for its seeds 0, 1, 2 (`TRAINED_REFERENCE`: 48 pair runs),
    in bf16 and in f32: per-pair rotation errors beside the JAX package's
    in the same dtype on the same draws and beside the port's f32 on the
    CPU; the phase fails when the median of the port's 48 rotation errors
    exceeds the JAX package's on the same draws by more than max(2
    degrees, the JAX package's draw-seed spread), in either dtype.  The
    same draws leave the numeric differences, which the ScanNet
    recurrence amplifies: the JAX package's own bf16 and f32 runs on one
    seed's draws differ by more than 1 degree on 13 of 16 pairs.
    (c) Pair 0's first completion input through the net on the card in
    f32 and in bf16 and on this machine's CPU in f32: the card's f32
    within relative L2 2e-4 of the CPU's (the bound of `tests/
    test_torch_scnet.py::test_shipped_comp_weights_forward_matches_flax`),
    and the card's bf16 at most twice as far from the card's f32 as the
    JAX package's bf16 is from its f32 on the same input (in the file).
    A missing npz fails the phase."""
    import math
    import numpy as np
    import torch
    from relativepose_tpu_torch.cli import evaluate
    from relativepose_tpu_torch.data import datasets as dsets
    from relativepose_tpu_torch.eval import harness
    from relativepose_tpu_torch.ops import kernels
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, TRAINED_REFERENCE)) as f:
        reference = json.load(f)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trained_")
    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        for dataset, ref in JAX_TRAINED.items():
            path = os.path.join(root, "relativepose_tpu", "data",
                                "pretrained", f"{dataset}.comp.npz")
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"5g: the shipped weights {path} are not in this "
                    "checkout")
            exp = f"trained_{dataset}"
            flags = ["--dataList", "synthetic", "--synthetic_family",
                     dataset, "--method", "ours", "--maxIter", str(B),
                     "--batch_pairs", str(B), "--comp_ckpt", path, "--rm",
                     "--exp", exp]
            print(f"evaluate {exp}: {B} pairs, --comp_ckpt "
                  f"{os.path.relpath(path, root)}; the CLI's statistics "
                  "and summary follow", flush=True)
            kernels.reset_launch_counts()
            runner = evaluate.main(flags + ["--device", "cuda"])
            counts = read_counts()
            add_counts(launches, counts)
            rows = runner.error_stats
            if len(rows) != B:
                raise AssertionError(f"{exp}: {len(rows)} result rows")
            check_pose_rows(exp, rows)
            bad = {k: v for k, v in runner.summary().items()
                   if v is not None and not math.isfinite(v)}
            if bad:
                raise AssertionError(f"{exp}: summary values {bad}")
            if counts.get(kernels.PAIR_WEIGHT.name) != 3:
                raise AssertionError(f"{exp}: launches {counts}, "
                                     "expected 3 of K1")
            rot = np.array([float(r["err_ad"]) for r in rows])
            trans = np.array([float(r["err_t"]) for r in rows])
            buckets = [harness.bucket_of(float(r["overlap"])) for r in rows]
            for b in harness.OVERLAP_BUCKETS:
                sel = [i for i, x in enumerate(buckets) if x == b]
                mine = (f"rotation {rot[sel].mean():.3f} deg, "
                        f"translation {trans[sel].mean():.4f}"
                        if sel else "no pairs")
                print(f"  {exp} overlap {b}: {len(sel)} pairs, {mine}; "
                      f"JAX {ref['buckets'][b]}", flush=True)
            print(f"evaluate {exp}: median rotation error "
                  f"{np.median(rot):.3f} deg, translation "
                  f"{np.median(trans):.4f} (the CLI's draws; JAX on its "
                  f"draw seeds 0, 1, 2: {ref['rot_medians_deg']} deg, "
                  f"{ref['trans_medians']}); launches {counts}; the call "
                  f"{B / runner.compile_s:.3f} pairs/s ({B} pairs in "
                  f"{runner.compile_s:.2f} s, the first call of this "
                  f"net); on {card}", flush=True)

            # (b) the same evaluation function on the JAX package's draws
            rec = reference["datasets"][dataset]
            offsets = sorted(rec["runs"], key=int)
            args = evaluate._parse_args(flags + ["--device", "cuda"])
            cfg = evaluate.eval_config(args)
            pipe_cfg = evaluate.pipeline_config(args, cfg)
            hp = harness.hyper_params_from_table(
                cfg.sigma_table, alter_steps=cfg.alter_steps)
            source = dsets.SyntheticPairs(args.family, n=B,
                                          seed=args.eval_seed,
                                          ramp_weight=args.ramp_weight,
                                          n_clutter=args.n_clutter)
            ds, dt, T_gt, _ = next(iter(dsets.batched(source, B,
                                                      max_items=B)))
            spread = max(ref["rot_medians_deg"]) - \
                min(ref["rot_medians_deg"])
            port_cpu = np.concatenate([rec["runs"][o]["port_cpu_f32"]
                                       ["rot_deg"] for o in offsets])
            nets, first = {}, []
            for dtype, bf16 in (("bf16", 1), ("f32", 0)):
                args.bf16 = bf16
                t = time.perf_counter()
                factory, params = evaluate.scnet_fn_factory_from_checkpoint(
                    args, pipe_cfg.layout)
                torch.cuda.synchronize()
                load_s = time.perf_counter() - t
                nets[dtype] = factory(None, None, params)

                def spied(data_s, data_t, p, fn=nets[dtype]):
                    def scnet_fn(x):
                        if not first:
                            first.append(x[:1].clone())
                        return fn(x)
                    return scnet_fn

                run = harness.make_batched_eval_fn(spied, cfg, pipe_cfg,
                                                   "cuda")
                mine, jax_rot, call_s = [], [], []
                for off in offsets:
                    kernels.reset_launch_counts()
                    t = time.perf_counter()
                    out = run(ds, dt, T_gt, 0, params, hp,
                              draws=trained_draws(rec["runs"][off]["draws"],
                                                  "cuda"))
                    call_s.append(time.perf_counter() - t)
                    counts = read_counts()
                    add_counts(launches, counts)
                    if counts.get(kernels.PAIR_WEIGHT.name) != 3:
                        raise AssertionError(f"{exp} {dtype}: launches "
                                             f"{counts}, expected 3 of K1")
                    check_pose_rows(f"{exp} {dtype}",
                                    [{"T_hat": T} for T in out["T_hat"]])
                    got = out["err_ad"].astype(np.float64)
                    ref_rot = np.array(rec["runs"][off][f"jax_{dtype}"]
                                       ["rot_deg"])
                    print(f"evaluate {exp} {dtype}, the JAX package's draws "
                          f"of seed {off}: median rotation error "
                          f"{np.median(got):.3f} deg (JAX "
                          f"{np.median(ref_rot):.3f}); per pair "
                          f"{np.round(got, 3).tolist()}, JAX "
                          f"{np.round(ref_rot, 3).tolist()}", flush=True)
                    mine.append(got)
                    jax_rot.append(ref_rot)
                mine = np.concatenate(mine)
                jax_rot = np.concatenate(jax_rot)
                limit = float(np.median(jax_rot)) + max(2.0, spread)
                agree = int(np.sum(np.abs(mine - jax_rot) <= 1.0))
                near = int(np.sum(np.abs(mine - port_cpu) <= 1.0))
                print(f"evaluate {exp} {dtype}, the JAX package's draws of "
                      f"seeds {offsets}: median rotation error of the "
                      f"{mine.size} pair runs {np.median(mine):.3f} deg "
                      f"(JAX {dtype} {np.median(jax_rot):.3f}, limit "
                      f"{limit:.3f}: + max(2, its draw-seed spread "
                      f"{spread:.3f}); the port's f32 on the CPU "
                      f"{np.median(port_cpu):.3f}); {agree} of {mine.size} "
                      f"within 1 deg of JAX's, {near} of the port's f32 on "
                      f"the CPU; weights loaded and converted in "
                      f"{load_s:.2f} s; a call of {B} pairs "
                      f"{min(call_s):.2f}-{max(call_s):.2f} s; on {card}",
                      flush=True)
                if not np.median(mine) <= limit:
                    raise AssertionError(
                        f"{exp} {dtype}: median rotation error "
                        f"{np.median(mine)} over {limit}")

            # (c) the completed pano of pair 0's first step
            args.bf16, args.device = 0, "cpu"
            cpu_net = evaluate.scnet_fn_factory_from_checkpoint(
                args, pipe_cfg.layout)[0](None, None, {})
            x = first[0]
            with torch.no_grad():
                y32 = nets["f32"](x)
                y16 = nets["bf16"](x)
                t = time.perf_counter()
                ycpu = cpu_net(x.cpu())
                cpu_s = time.perf_counter() - t
            if not (torch.isfinite(y16).all() and torch.isfinite(y32).all()):
                raise AssertionError(f"{exp}: non-finite completed pano")
            d_cpu = rel_l2(y32.cpu(), ycpu)
            d_16 = rel_l2(y16, y32)
            pano = rec["pano_rel_l2"]
            ref16 = pano["jax_bf16_vs_jax_f32"]
            print(f"evaluate {exp} pair 0, first completion input "
                  f"{list(x.shape)}: relative L2 card f32 against CPU f32 "
                  f"{d_cpu:.3e} (bound 2e-4; the CPU forward {cpu_s:.1f} "
                  f"s), card bf16 against card f32 {d_16:.3e} (bound "
                  f"{2 * ref16:.3e}: twice the JAX package's bf16 against "
                  f"its f32, {ref16:.3e}); on the CPU (the file), from "
                  f"the f64 function: the port's f32 "
                  f"{pano['port_f32_vs_f64']:.3e}, the JAX package's f32 "
                  f"{pano['jax_f32_vs_f64']:.3e} and bf16 "
                  f"{pano['jax_bf16_vs_f64']:.3e}", flush=True)
            if not d_cpu <= 2e-4:
                raise AssertionError(f"{exp}: card f32 pano {d_cpu} from "
                                     "the CPU's")
            if not d_16 <= 2 * ref16:
                raise AssertionError(f"{exp}: card bf16 pano {d_16} from "
                                     f"f32, over {2 * ref16}")
            del nets, first, cpu_net
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)


TRAIN_B = 8   # pairs per training step, the CLIs' default


def check_finite(name, metrics):
    bad = {k: float(v) for k, v in metrics.items()
           if not math.isfinite(float(v))}
    if bad:
        raise AssertionError(f"{name}: non-finite {bad}")


def drive_trainer(name, step, gather, card):
    """Times one trainer's step (a full step with its augmentation, then
    each part alone), checks its metrics and that 20 steps on one fixed
    batch lower the loss.  step(batch, draws=None) -> metrics; with draws
    None it draws them itself and returns them with the metrics."""
    import torch
    from relativepose_tpu_torch.ops import kernels
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()   # the state and earlier phases'
    seen = []

    def full():
        seen.append(step(gather())[0])

    ms = cuda_ms(full, 5)
    ms_aug = cuda_ms(gather, 5)
    batch = gather()
    ms_train = cuda_ms(lambda: seen.append(step(batch)[0]), 5)
    peak = torch.cuda.max_memory_allocated()
    for m in seen:
        check_finite(name, m)
    metrics, draws = step(batch)
    losses = [float(metrics["loss"])]
    for _ in range(19):
        m, _ = step(batch, draws)
        check_finite(name, m)
        losses.append(float(m["loss"]))
    counts = read_counts()
    print(f"{name} step: {ms:.3f} ms per step of {TRAIN_B} pairs "
          f"({TRAIN_B / ms * 1e3:.3f} pairs/s; 5 steps after 1 warm-up, "
          f"CUDA events); augmentation (gather_batch) alone {ms_aug:.3f} "
          f"ms, forward+backward+Adam alone {ms_train:.3f} ms; peak device "
          f"memory {peak / 2**30:.3f} GiB (max_memory_allocated), "
          f"{(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} "
          f"GiB allocated before the first step; grad "
          f"norm {float(seen[-1]['grad_norm']):.4g}; kernel launches "
          f"{counts}; on {card}", flush=True)
    print(f"{name} step: loss over 20 steps on one fixed batch "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}", flush=True)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: loss did not fall: {losses}")
    return ms


def phase_train_steps(card):
    """6a: the feature step, then the completion step against the feature
    net it trained, at full width on 16 resident synthetic suncg pairs.
    Returns the completion step's call and its seconds, for 5f."""
    import torch
    from relativepose_tpu_torch.data import datasets as dsets
    from relativepose_tpu_torch.data import device_store as dstore
    from relativepose_tpu_torch.train import completion, feature
    store = dstore.DeviceStore(
        dsets.SyntheticPairs("suncg", n=2 * TRAIN_B, seed=0,
                             full_frames=False),
        device="cuda", with_full_frames=False)
    gen = torch.Generator(device="cuda").manual_seed(3)
    pick = torch.Generator().manual_seed(4)

    def gather():
        idx = torch.randperm(store.n, generator=pick)[:TRAIN_B].cuda()
        return dstore.gather_batch(store.arrays, idx, "suncg",
                                   generator=gen)

    fcfg = feature.FeatureTrainConfig(dtype=torch.bfloat16)
    fstate = feature.init_state(fcfg, "cuda", seed=0)

    def fstep(batch, draws=None):
        if draws is None:
            draws = feature.draw_negatives(fcfg, batch, gen)
        return feature.train_step(fstate, batch, draws, fcfg), draws

    drive_trainer("feature", fstep, gather, card)
    net_f = fstate.models["net_f"]
    del fstate
    ccfg = completion.CompletionTrainConfig(dtype=torch.bfloat16)
    cstate = completion.init_state(ccfg, "cuda", seed=0, net_f=net_f)

    def cstep(batch, draws=None):
        if draws is None:
            draws = completion.draw(ccfg, batch, gen)
        return completion.train_step(cstate, batch, draws, ccfg), draws

    ms = drive_trainer("completion", cstep, gather, card)
    return (lambda: cstep(gather())), ms / 1e3


def check_cli_run(name, ckpt, root_key):
    """A training CLI's run: its orbax checkpoint directory holds the JAX
    trainers' state tree, whose params hold `root_key`, and every scalar
    it logged is finite, with train and val losses among them."""
    import numpy as np
    from relativepose_tpu_torch.utils import orbax_read
    from relativepose_tpu_torch.utils.checkpoint import restore_params
    if not orbax_read.is_checkpoint(ckpt):
        raise AssertionError(f"{name}: no orbax checkpoint {ckpt}")
    state = restore_params(os.path.dirname(ckpt))
    tree = state["params"]
    if root_key not in tree or not {"opt_state", "step"} <= set(state):
        raise AssertionError(f"{name}: {ckpt} holds {sorted(state)}, "
                             f"params {sorted(tree)[:4]}...")
    n_params = sum(int(np.prod(a.shape)) for a in _leaves(tree))
    path = os.path.join(os.path.dirname(os.path.dirname(ckpt)),
                        "tensorboard", "scalars.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    keys = {k for r in rows for k in r["values"]}
    for r in rows:
        check_finite(name, r["values"])
    if not {"train_loss", "val_loss"} <= keys:
        raise AssertionError(f"{name}: logged {sorted(keys)}")
    last = {k: v for r in rows for k, v in r["values"].items()
            if k.endswith("loss")}
    print(f"{name}: checkpoint {os.path.basename(ckpt)} with {n_params} "
          f"parameters; {len(rows)} logged rows, last losses {last}",
          flush=True)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def phase_train_clis(card, work):
    """6b: the feature CLI, then the completion CLI against the netF it
    saved, in the directory `work`, at the CLIs' defaults; then the write
    and read-back of the completion state (`check_orbax_write`).  Returns
    the completion run's params directory."""
    from relativepose_tpu_torch.cli import train_completion, train_feature
    from relativepose_tpu_torch.ops import kernels
    cwd = os.getcwd()
    cache = os.environ.get("RPTPU_SYNTH_CACHE")
    # the completion run reads the pairs the feature run rendered
    os.environ["RPTPU_SYNTH_CACHE"] = os.path.join(work, "pairs")
    common = ["--dataList", "synthetic", "--debug", "--max_epoch", "1",
              "--train_duration", "6", "--batch_size", str(TRAIN_B), "--rm",
              "--device", "cuda"]
    try:
        os.chdir(work)
        kernels.reset_launch_counts()
        t = time.perf_counter()
        feat_ckpt = train_feature.main(["--exp", "feat"] + common)
        print(f"train_feature: {time.perf_counter() - t:.1f} s on {card}",
              flush=True)
        check_cli_run("train_feature", feat_ckpt, "net_f")
        t = time.perf_counter()
        comp_ckpt = train_completion.main(
            ["--exp", "comp", "--featurelearning", "1", "--feat_ckpt",
             os.path.dirname(feat_ckpt)] + common)
        print(f"train_completion: {time.perf_counter() - t:.1f} s on "
              f"{card}; kernel launches {read_counts()}", flush=True)
        check_cli_run("train_completion", comp_ckpt, "ConvBlock_0")
    finally:
        os.chdir(cwd)
        if cache is None:
            os.environ.pop("RPTPU_SYNTH_CACHE", None)
        else:
            os.environ["RPTPU_SYNTH_CACHE"] = cache
    params = os.path.dirname(comp_ckpt)
    check_orbax_write(card, params, work)
    return params


def _leaf_arrays(tree, prefix=""):
    """{'/'-joined path: array} of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_leaf_arrays(v, key))
        else:
            out[key] = v
    return out


def _digests(tree):
    """{key path: (dtype, sha256)} of every leaf of a state tree."""
    import hashlib
    import numpy as np
    from relativepose_tpu_torch.utils.orbax_write import flatten
    return {str([k for k, _ in keys]): leaf if isinstance(leaf, str) else (
        np.asarray(leaf).dtype.str,
        hashlib.sha256(np.ascontiguousarray(leaf).tobytes()).hexdigest())
        for keys, leaf in flatten(tree)}


def check_orbax_write(card, params, work):
    """6b: the completion CLI's newest checkpoint restored into a
    full-width completion state on the card (its parameters within 1e-6
    of the checkpoint's), that state written by the port's manager, timed
    from the card's tensors to the closed files, and read back by the
    port's reader: every leaf's sha256 as in `flax_state()`."""
    import numpy as np
    import torch
    from relativepose_tpu_torch.train import completion
    from relativepose_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        restore_params,
    )
    state = completion.init_state(completion.CompletionTrainConfig(
        dtype=torch.bfloat16), "cuda", seed=1)
    state, ok = CheckpointManager(params).restore_into(state)
    want = _leaf_arrays(state.flax_state()["params"])
    saved = _leaf_arrays(restore_params(params)["params"])
    if not ok or want.keys() != saved.keys():
        raise AssertionError("orbax: the completion checkpoint did not "
                             "restore into a full-width state")
    err = max(float(np.abs(want[k] - saved[k]).max()) for k in want)
    if err > 1e-6:
        raise AssertionError(f"orbax: restored parameters off by {err}")
    out = os.path.join(work, "orbax_write")
    torch.cuda.synchronize()
    t = time.perf_counter()
    path = CheckpointManager(out).save(state.step, state)
    secs = time.perf_counter() - t
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)
    t = time.perf_counter()
    back = restore_params(out)
    read_s = time.perf_counter() - t
    got, ref = _digests(back), _digests(state.flax_state())
    bad = sorted(k for k in set(got) | set(ref) if got.get(k) != ref.get(k))
    if bad:
        raise AssertionError(f"orbax: {len(bad)} leaves read back differ "
                             f"from the state: {bad[:4]}")
    print(f"orbax write of the full-width completion state (SCNet params, "
          f"Adam mu and nu, netF; {len(ref)} leaves, step {state.step}): "
          f"{size} bytes in {secs:.3f} s, {size / secs / 1e6:.1f} MB/s, "
          f"from the card's tensors to closed files; read back by the "
          f"port's reader in {read_s:.3f} s, every leaf's sha256 as in "
          f"memory; restored parameters within {err:.3g} of the CLI's "
          f"checkpoint; on the host of {card}", flush=True)


FT_B = 4            # pairs per fine-tuning step, the CLI's default
FT_STEPS = 2        # recurrence depth while fine-tuning, the CLI's default
SIGMA0 = (0.2615, 0.2615, 0.04, 0.01)


def phase_finetune(card, comp_ckpt, data, work, launches):
    """6c: the fine-tuning step at the CLI's defaults (SCNet from 6b's
    params directory `comp_ckpt`, bf16 compute, batch 4, remat) timed,
    against remat=False on the same draws, then `cli.finetune_pose.main`,
    whose checkpoint must drive the evaluation pipeline.  Returns its
    params directory."""
    import dataclasses
    import argparse
    import re
    import numpy as np
    import torch
    from relativepose_tpu_torch.cli import finetune_pose as ft_cli
    from relativepose_tpu_torch.cli.evaluate import (
        scnet_fn_factory_from_checkpoint,
    )
    from relativepose_tpu_torch.data import datasets as dsets
    from relativepose_tpu_torch.data.device_store import DeviceStore
    from relativepose_tpu_torch.eval import harness
    from relativepose_tpu_torch.match.solver import SolverHyperParams
    from relativepose_tpu_torch.models import convert
    from relativepose_tpu_torch.models.scnet import SCNet
    from relativepose_tpu_torch.ops import kernels
    from relativepose_tpu_torch.pipeline import recurrent
    from relativepose_tpu_torch.train import finetune_pose as ft
    from relativepose_tpu_torch.utils.checkpoint import restore_params

    # the fine-tuning CLI's pipeline: both kernels off (no backward)
    cfg = dataclasses.replace(
        pipeline_config("suncg", remat=True,
                        solver=dict(pallas_w_build=False)),
        alter_steps=FT_STEPS)
    hp = harness.hyper_params_from_table(
        harness.default_sigma_table("suncg")[:FT_STEPS],
        alter_steps=FT_STEPS)
    ft_cfg = ft.PoseFinetuneConfig(dtype=torch.bfloat16)
    net = SCNet(snumclass=cfg.snumclass, ngf=64, dtype=torch.bfloat16)
    convert.load_flax_params(net, restore_params(comp_ckpt)["params"])
    state = ft.init_state(net.cuda(), ft_cfg)
    store = DeviceStore(dsets.SyntheticPairs("suncg", n=2 * FT_B, seed=0,
                                             view_detail_jitter=True),
                        device="cuda")
    pick = np.random.RandomState(0)
    batches = [ft.gather_eval_pairs(store.arrays, torch.from_numpy(
        pick.choice(store.n, FT_B, replace=False)).cuda()) for _ in range(2)]

    # first (it also warms up): forward+backward with and without remat
    kernels.reset_launch_counts()
    out = {}
    for remat in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the rematerialised steps run cuDNN deterministically (their
        # recompute must repeat the forward); so does the plain run here
        with recurrent.cudnn_deterministic():
            loss, _ = ft.loss_fn(
                net, None, *batches[0], dataclasses.replace(cfg, remat=remat),
                hp, ft_cfg,
                generator=torch.Generator(device="cuda").manual_seed(9))
            g = torch.autograd.grad(loss, list(net.parameters()),
                                    allow_unused=True)
        g = torch.cat([x.float().flatten() for x in g if x is not None])
        torch.cuda.synchronize()
        out[remat] = (float(loss.detach()), g,
                      torch.cuda.max_memory_allocated())
    (l1, g1, p1), (l0, g0, p0) = out[True], out[False]
    cos = float(torch.nn.functional.cosine_similarity(g1, g0, dim=0))
    n1, n0 = float(g1.norm()), float(g0.norm())
    print(f"finetune forward+backward on one batch: remat loss {l1:.6f}, "
          f"plain {l0:.6f}; gradient norms {n1:.6g} / {n0:.6g}, cosine "
          f"{cos:.7f}; peak device memory remat {p1 / 2**30:.3f} GiB, "
          f"plain {p0 / 2**30:.3f} GiB; on {card}", flush=True)
    if l1 != l0 or abs(n1 - n0) > 1e-3 * n0 or cos < 0.9999 or \
            not p1 < p0:
        raise AssertionError("remat does not match the plain run")
    del g1, g0

    step = ft.make_finetune_step(cfg, hp, ft_cfg)
    gen = torch.Generator(device="cuda").manual_seed(42)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # a full step first: the timed one is warm (the optimizer's state is
    # allocated, the step's kernels have run)
    warm = step(state, *batches[0], generator=gen)
    torch.cuda.synchronize()
    host, seen = 0.0, []
    start.record()
    for b in batches[1:]:
        t = time.perf_counter()
        seen.append(step(state, *b, generator=gen))
        host += time.perf_counter() - t
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / len(seen)
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    for m in [warm] + seen:
        check_finite("finetune", m)
    gnorm = float(seen[-1]["grad_norm"])
    if not gnorm > 0:
        raise AssertionError(f"finetune: grad_norm {gnorm}")
    if any(counts.values()):
        raise AssertionError(f"finetune steps launched kernels: {counts}")
    print(f"finetune step (remat, batch {FT_B}, {FT_STEPS} recurrence "
          f"steps, bf16 SCNet at ngf 64): {ms:.3f} ms per step "
          f"({FT_B / ms * 1e3:.3f} pairs/s; {len(seen)} step(s) after one "
          f"warm-up step, CUDA events); host time to "
          f"enqueue a step {host / len(seen) * 1e3:.3f} ms; peak device "
          f"memory {peak / 2**30:.3f} GiB (max_memory_allocated), "
          f"{(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} "
          f"GiB allocated before; losses "
          f"{[round(float(m['loss']), 4) for m in seen]}, grad norm "
          f"{gnorm:.4g}; kernel launches {counts}; on {card}", flush=True)
    del state

    cwd = os.getcwd()
    try:
        os.chdir(work)
        t = time.perf_counter()
        # 1 step on 8 pairs (not 3 on 32): 6c and 6d together get at
        # most 180 s
        ckpt = os.path.dirname(ft_cli.main([
            "--exp", "ft", "--rm", "--comp_ckpt", comp_ckpt, "--synthetic_n",
            "8", "--steps", "1", "--batch_pairs", str(FT_B), "--log_every",
            "1", "--save_every", "1", "--device", "cuda"]))
        secs = time.perf_counter() - t
        with open(os.path.join("experiments", "exp_ft", "exp_ft.log")) as f:
            log = f.read()
    finally:
        os.chdir(cwd)
    kept = int(re.search(r"(\d+)/\d+ pairs at overlap", log).group(1))
    losses = [float(x) for x in re.findall(r"step \d+/\d+ loss (\S+)", log)]
    print(f"finetune_pose CLI: {secs:.1f} s, {kept}/8 pairs kept by the "
          f"overlap filter, losses {losses}; on {card}", flush=True)
    if kept < FT_B or len(losses) != 1 or not np.isfinite(losses).all():
        raise AssertionError(f"finetune_pose CLI: {kept} kept, {losses}")

    args = argparse.Namespace(
        torch_comp_ckpt=None, comp_ckpt=ckpt, outputType="rgbdnsf",
        snumclass=15, featureDim=32, ngf=64, internal_size="224x224",
        batchnorm=1, skipLayer=1, useTanh=1, bf16=1, device="cuda")
    factory, _ = scnet_fn_factory_from_checkpoint(args, None)
    data_s, data_t, _ = data
    kernels.reset_launch_counts()
    with torch.no_grad():
        T = recurrent.estimate_pose_via_completion(
            factory(None, None, None), data_s, data_t, SolverHyperParams(),
            pipeline_config("suncg"),
            generator=torch.Generator(device="cuda").manual_seed(7))
    torch.cuda.synchronize()
    counts = read_counts()
    add_counts(launches, counts)
    check_poses(T)
    print(f"the fine-tuned checkpoint in the evaluation pipeline: finite "
          f"orthonormal poses of {B} pairs, launches {counts}", flush=True)
    return ckpt


def phase_tune_sigma(card, ckpt, work, launches):
    """6d: `cli.tune_sigma.main` with the finite differences (K1 in every
    objective evaluation), then exact-gradient Adam on the same cache;
    K1 against the plain W build on the level-0 objective; the seconds of
    an objective evaluation and of a gradient step."""
    import numpy as np
    import torch
    from relativepose_tpu_torch.cli import tune_sigma
    from relativepose_tpu_torch.match.solver import SolverStaticConfig
    from relativepose_tpu_torch.ops import kernels
    from relativepose_tpu_torch.tune import sigma as st
    cache = os.path.join(work, "prims.npy")
    # 8 pairs and 1 iteration of each method (not 16 and 4): 6c and 6d
    # together get at most 180 s
    common = ["--num_pairs", "8", "--rlevel", "3", "--comp_ckpt", ckpt,
              "--cache", cache, "--device", "cuda"]
    tables = {}
    k1 = 0
    for method, extra in (("fd", ["--max_iter", "1"]),
                          ("grad", ["--grad_steps", "1"])):
        mtime = os.path.getmtime(cache) if os.path.exists(cache) else None
        kernels.reset_launch_counts()
        t = time.perf_counter()
        table = tune_sigma.main(common + extra + [
            "--tune_method", method, "--out",
            os.path.join(work, f"sigma_{method}.txt")])
        secs = time.perf_counter() - t
        counts = read_counts()
        add_counts(launches, counts)
        k1 += counts["pair_weight_matrix"]
        kept = [bool(np.allclose(r, SIGMA0)) for r in table]
        print(f"tune_sigma --tune_method {method}: {secs:.1f} s, launches "
              f"{counts}, table {np.round(table, 5).tolist()} (rows kept "
              f"at sigma0 by the held-out gate: {kept}); on {card}",
              flush=True)
        if table.shape != (3, 4) or not np.isfinite(table).all() or \
                not (table > 0).all():
            raise AssertionError(f"tune_sigma {method}: {table}")
        if method == "fd" and counts["pair_weight_matrix"] == 0:
            raise AssertionError("tune_sigma fd did not launch K1")
        if method == "grad" and (os.path.getmtime(cache) != mtime
                                 or any(counts.values())):
            raise AssertionError("tune_sigma grad did not reuse the cache")
        tables[method] = table

    blob = np.load(cache, allow_pickle=True).item()
    prims = st.stack_primitives(blob["primitives"][0], "cuda")
    rgt = blob["R_gt"]
    obj = {k: st.make_objective(*prims, rgt, SolverStaticConfig(
        pallas_w_build=k)) for k in (True, False)}
    worst = 0.0
    for sig in (SIGMA0, (0.3, 0.2, 0.05, 0.02)):
        with torch.no_grad():
            v1, v0 = (float(obj[k](np.asarray(sig, np.float32)))
                      for k in (True, False))
        rel = abs(v1 - v0) / max(abs(v0), 1e-30)
        worst = max(worst, rel)
        print(f"level-0 objective at sigma {sig}: K1 {v1:.8g}, plain W "
              f"build {v0:.8g}, relative difference {rel:.3e}", flush=True)
    if worst > 1e-4:
        raise AssertionError(f"K1 objective off the plain one by {worst}")

    def evals():
        with torch.no_grad():
            obj[True](np.asarray(SIGMA0, np.float32))

    def grad_step():
        log_sig = torch.log(torch.tensor(SIGMA0)).requires_grad_(True)
        obj[False](torch.exp(log_sig)).backward()

    # both paths are warm: the comparison above and the 'grad' run
    times = {}
    for name, fn, reps in (("fd", evals, 2), ("grad", grad_step, 1)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) / reps
    print(f"sigma objective over {len(blob['primitives'][0])} pairs of "
          f"level 0: {times['fd']:.4f} s per evaluation with K1 (the "
          f"finite-difference path), {times['grad']:.4f} s per "
          f"value-and-gradient step with the plain W build; K1 launched "
          f"{k1} times in 6d's two runs; on {card}", flush=True)


# ---------------------------------------------------------------------------
# phase 7: the classical baselines, original-repository checkpoints, the mesh
# ---------------------------------------------------------------------------

CLASSICAL_PAIRS = 4      # synthetic suncg pairs; 2 pass the 0.1 overlap skip
S4PCS_BUDGET_S = 3       # RPTPU_S4PCS_BUDGET for 7a (the default is 240 s)


def check_pose_rows(name, rows):
    import numpy as np
    if len(rows) < 2:
        raise AssertionError(f"{name}: {len(rows)} recorded rows")
    for r in rows:
        T = np.asarray(r["T_hat"], np.float64)
        R = T[:3, :3]
        if not np.isfinite(T).all() or \
                np.abs(R @ R.T - np.eye(3)).max() > 1e-3:
            raise AssertionError(f"{name}: pose {T.tolist()}")


def phase_classical(card):
    """7a: `cli.evaluate.main` with gs, fgs, cgs and super4pcs on synthetic
    suncg pairs (observed-face clouds of the 160x640 panos), the
    bookkeeping on the card and the registration in the native library,
    which the first call builds with g++."""
    import numpy as np
    from relativepose_tpu_torch.cli import evaluate
    from relativepose_tpu_torch.native import registration as natreg
    tmp = tempfile.mkdtemp(prefix="chip_smoke_classical_")
    cwd = os.getcwd()
    saved = {k: os.environ.get(k)
             for k in ("RPTPU_S4PCS_BUDGET", "RPTPU_SYNTH_CACHE")}
    # super4pcs's search is cut to a few seconds a pair here, and the four
    # methods read the pairs the first one rendered
    os.environ["RPTPU_S4PCS_BUDGET"] = str(S4PCS_BUDGET_S)
    os.environ["RPTPU_SYNTH_CACHE"] = os.path.join(tmp, "pairs")
    try:
        os.chdir(tmp)
        for method in ("gs", "fgs", "cgs", "super4pcs"):
            t = time.perf_counter()
            runner = evaluate.main([
                "--dataList", "synthetic", "--synthetic_family", "suncg",
                "--method", method, "--maxIter", str(CLASSICAL_PAIRS),
                "--rm", "--exp", method, "--device", "cuda"])
            secs = time.perf_counter() - t
            rows = runner.error_stats
            check_pose_rows(method, rows)
            med = float(np.median([float(r["err_ad"]) for r in rows]))
            print(f"classical {method}: {len(rows)} of {CLASSICAL_PAIRS} "
                  f"pairs recorded (pair_idx "
                  f"{[int(r['pair_idx']) for r in rows]}); "
                  f"{secs / len(rows):.2f} host s per recorded pair "
                  f"({secs:.1f} s in all); median rotation error "
                  f"{med:.3f} deg; on {card}", flush=True)
        print(f"native library: built with g++ in "
              f"{natreg.build_seconds:.1f} s on {card}"
              if natreg.build_seconds else "native library: cached build",
              flush=True)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reference_scnet_state_dict(net):
    """The port's SCNet -> the original repository's state dict: names by
    `torch_import.scnet_name_map`, torch layouts, BN weight = scale + 1
    (the import map run backwards)."""
    import numpy as np
    import torch
    from relativepose_tpu_torch.models import convert
    from relativepose_tpu_torch.utils.torch_import import scnet_name_map
    tree = convert.flax_params(net)
    sd = {}
    for tname, (fname, kind) in scnet_name_map(
            net.layout.output_type).items():
        node = tree[fname]
        if kind == "plain_conv":
            sd[f"{tname}.weight"] = node["kernel"].transpose(3, 2, 0, 1)
            sd[f"{tname}.bias"] = node["bias"]
            continue
        if kind == "deconv_block":
            w = node["kernel"].transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        else:
            w = node["Conv_0"]["kernel"].transpose(3, 2, 0, 1)
        sd[f"{tname}.0.weight"] = w
        sd[f"{tname}.1.weight"] = node["BatchNorm2d_0"]["scale"] + 1.0
        sd[f"{tname}.1.bias"] = node["BatchNorm2d_0"]["bias"]
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


def reference_resnet_state_dict(net):
    """The port's Resnet18_8s -> the original feature net's state dict,
    with running statistics 0 and 1."""
    sd = {}
    t = "resnet18_32s"

    def bn(name, mod):
        sd[f"{name}.weight"] = mod.weight.detach()
        sd[f"{name}.bias"] = mod.bias.detach()
        sd[f"{name}.running_mean"] = 0.0 * mod.bias.detach()
        sd[f"{name}.running_var"] = 0.0 * mod.bias.detach() + 1.0

    sd[f"{t}.conv1.weight"] = net.conv1.weight.detach()
    bn(f"{t}.bn1", net.bn1)
    for i, blk in enumerate(net.blocks):
        tb = f"{t}.layer{i // 2 + 1}.{i % 2}"
        sd[f"{tb}.conv1.weight"] = blk.conv1.weight.detach()
        bn(f"{tb}.bn1", blk.bn1)
        sd[f"{tb}.conv2.weight"] = blk.conv2.weight.detach()
        bn(f"{tb}.bn2", blk.bn2)
        if blk.down_conv is not None:
            sd[f"{tb}.downsample.0.weight"] = blk.down_conv.weight.detach()
            bn(f"{tb}.downsample.1", blk.down_bn)
    for n in (8, 16, 32):
        conv = getattr(net, f"score{n}")
        sd[f"score_{n}s.weight"] = conv.weight.detach()
        sd[f"score_{n}s.bias"] = conv.bias.detach()
    return {k: v.float().cpu().contiguous() for k, v in sd.items()}


def save_reference(sd, path):
    """A `.pth.tar` as the original repository's DataParallel runs save
    it: `module.` prefixes under `state_dict`."""
    import torch
    torch.save({"epoch": 1, "state_dict": {f"module.{k}": v
                                           for k, v in sd.items()}}, path)
    return path


def phase_torch_checkpoint(card, work, launches):
    """7b: original-repository checkpoints of a seeded full-width SCNet
    and feature net: the import gives back every SCNet parameter, the
    evaluation CLI runs on the SCNet checkpoint and the completion CLI
    trains against the feature net's."""
    import torch
    from relativepose_tpu_torch.cli import evaluate, train_completion
    from relativepose_tpu_torch.models.resnet import Resnet18_8s
    from relativepose_tpu_torch.models.scnet import SCNet
    from relativepose_tpu_torch.ops import kernels
    from relativepose_tpu_torch.utils import torch_import
    from relativepose_tpu_torch.utils.checkpoint import restore_params
    torch.manual_seed(5)
    net = SCNet()
    comp = save_reference(reference_scnet_state_dict(net),
                          os.path.join(work, "suncg.comp.pth.tar"))
    back = torch_import.load_scnet(torch_import.load_torch_state_dict(comp),
                                   SCNet())
    ref = net.state_dict()
    err = max(float((v - ref[k]).abs().max())
              for k, v in back.state_dict().items())
    print(f"torch checkpoint: {len(ref)} SCNet parameters back from the "
          f"reference names within {err:.3g} (bound 1e-6) on {card}",
          flush=True)
    if not err <= 1e-6:
        raise AssertionError(f"SCNet import round trip {err}")
    cwd = os.getcwd()
    cache = os.environ.get("RPTPU_SYNTH_CACHE")
    os.environ["RPTPU_SYNTH_CACHE"] = os.path.join(work, "pairs")
    try:
        os.chdir(work)
        kernels.reset_launch_counts()
        t = time.perf_counter()
        runner = evaluate.main([
            "--dataList", "synthetic", "--synthetic_family", "suncg",
            "--method", "ours", "--maxIter", "4", "--batch_pairs", "4",
            "--torch_comp_ckpt", comp, "--rm", "--exp", "torch_ck",
            "--device", "cuda"])
        counts = read_counts()
        add_counts(launches, counts)
        check_pose_rows("evaluate --torch_comp_ckpt", runner.error_stats)
        print(f"evaluate --torch_comp_ckpt (full width, bf16): "
              f"{len(runner.error_stats)} pairs in "
              f"{time.perf_counter() - t:.1f} s, finite orthonormal poses; "
              f"launches {counts}; on {card}", flush=True)
        torch.manual_seed(6)
        feat = save_reference(reference_resnet_state_dict(Resnet18_8s()),
                              os.path.join(work, "suncg.feat.pth.tar"))
        t = time.perf_counter()
        ckpt = train_completion.main([
            "--exp", "comp_tf", "--featurelearning", "1", "--torch_feat_ckpt",
            feat, "--dataList", "synthetic", "--debug", "--max_epoch", "1",
            "--train_duration", "2", "--batch_size", str(TRAIN_B),
            "--device_data", "0", "--log_every", "1", "--rm", "--device",
            "cuda"])
        print(f"train_completion --torch_feat_ckpt: "
              f"{time.perf_counter() - t:.1f} s on {card}", flush=True)
        check_cli_run("train_completion --torch_feat_ckpt", ckpt,
                      "ConvBlock_0")
        n = len(_digests(restore_params(os.path.dirname(ckpt))))
        print(f"train_completion --torch_feat_ckpt: {n} leaves in its "
              "orbax checkpoint", flush=True)
    finally:
        os.chdir(cwd)
        if cache is None:
            os.environ.pop("RPTPU_SYNTH_CACHE", None)
        else:
            os.environ["RPTPU_SYNTH_CACHE"] = cache


def leaf_digests(tree, prefix=()):
    """{'/'-joined path: {shape, dtype, sha256}} of a nested dict of
    arrays, as `tests/orbax_fixture.py` records the fixture's leaves."""
    import hashlib
    import numpy as np
    out = {}
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, dict):
            out.update(leaf_digests(v, path))
        else:
            a = np.ascontiguousarray(np.asarray(v))
            out["/".join(path)] = {
                "shape": list(a.shape), "dtype": a.dtype.str,
                "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


def phase_orbax(card, launches):
    """8: the JAX package's orbax checkpoints without JAX: the zstd
    decoder's g++ build; the committed fixture (a seeded SCNet at ngf 2
    that the JAX package's CheckpointManager wrote) read with every leaf's
    sha256 as recorded; the decoder's rate over the fixture's chunks; then
    `cli.evaluate --comp_ckpt <the fixture>` on 4 suncg pairs in one call:
    K1 launched 3 times, finite orthonormal poses."""
    import numpy as np
    from relativepose_tpu_torch.cli import evaluate
    from relativepose_tpu_torch.native import zstd
    from relativepose_tpu_torch.ops import kernels
    from relativepose_tpu_torch.utils.checkpoint import restore_params
    from relativepose_tpu_torch.utils.ocdbt import OcdbtReader
    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data")
    fixture = os.path.join(data, "orbax_scnet")
    with open(os.path.join(data, "orbax_scnet.json")) as f:
        record = json.load(f)
    zstd.build()
    print("zstd decoder: " + (f"g++ build {zstd.build_seconds:.1f} s"
                              if zstd.build_seconds else "cached build"),
          flush=True)
    t = time.perf_counter()
    tree = restore_params(fixture)
    read_ms = (time.perf_counter() - t) * 1e3
    got = leaf_digests(tree)
    bad = sorted(k for k in set(got) | set(record["leaves"])
                 if got.get(k) != record["leaves"].get(k))
    if bad:
        raise AssertionError(f"orbax fixture: leaves differ from "
                             f"orbax_scnet.json: {bad[:5]}")
    print(f"orbax fixture: {len(got)} leaves read in {read_ms:.1f} ms, "
          "every sha256 as recorded", flush=True)
    kv = OcdbtReader(os.path.join(fixture, "checkpoint_0001"))
    chunks = []
    for key in kv.keys():
        if not key.endswith("/.zarray"):
            frame = kv.read(key)
            chunks.append((frame, np.empty(zstd.decompress(frame).size,
                                           np.uint8)))
    per_pass = sum(out.nbytes for _, out in chunks)
    passes = -(-200_000_000 // per_pass)
    t = time.perf_counter()
    for _ in range(passes):
        for frame, out in chunks:
            zstd.decompress_into(frame, out)
    secs = time.perf_counter() - t
    mb = passes * per_pass / 1e6
    print(f"zstd decode: {mb:.1f} MB ({len(chunks)} chunks, "
          f"{sum(len(f) for f, _ in chunks)} bytes compressed, "
          f"{per_pass} decoded, x {passes}) in {secs:.3f} s: "
          f"{mb / secs:.1f} MB/s on the host of {card}", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_orbax_")
    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        kernels.reset_launch_counts()
        t = time.perf_counter()
        runner = evaluate.main([
            "--dataList", "synthetic", "--synthetic_family", "suncg",
            "--method", "ours", "--maxIter", "4", "--batch_pairs", "4",
            "--comp_ckpt", fixture, "--ngf", str(record["ngf"]), "--rm",
            "--exp", "orbax_ck", "--device", "cuda"])
        counts = read_counts()
        add_counts(launches, counts)
        check_pose_rows("evaluate --comp_ckpt <orbax>", runner.error_stats)
        if counts.get(kernels.PAIR_WEIGHT.name) != 3:
            raise AssertionError(f"evaluate --comp_ckpt <orbax>: launches "
                                 f"{counts}, expected 3 of K1")
        print(f"evaluate --comp_ckpt {os.path.relpath(fixture, cwd)} "
              f"--ngf {record['ngf']}: {len(runner.error_stats)} pairs in "
              f"{time.perf_counter() - t:.1f} s, finite orthonormal poses; "
              f"launches {counts}; on {card}", flush=True)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)


def phase_mesh(card):
    """7c: one completion step at full width (ngf 64, batch 8, bf16)
    through train/mesh.py on a 1-rank NCCL group, against the same step
    without a group: loss within 1e-3 relative, parameters within 1e-6
    for 99.9 % of them and within 2 lr + 1e-6 for all (the group's batch
    statistics divide sums where the plain path takes means)."""
    import torch
    import torch.distributed as dist
    from relativepose_tpu_torch.data import datasets as dsets
    from relativepose_tpu_torch.data import device_store as dstore
    from relativepose_tpu_torch.train import completion, mesh
    store = dstore.DeviceStore(
        dsets.SyntheticPairs("suncg", n=TRAIN_B, seed=0, full_frames=False),
        device="cuda", with_full_frames=False)
    cfg = completion.CompletionTrainConfig(dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = dstore.gather_batch(store.arrays,
                                torch.arange(TRAIN_B, device="cuda"),
                                "suncg", generator=gen)
    draws = completion.draw(cfg, batch, gen)
    runs = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        for name in ("plain", "mesh"):
            state = completion.init_state(cfg, "cuda", seed=0)
            if name == "mesh":
                mesh.init_distributed(0, 1, os.path.join(tmp, "store"),
                                      "cuda")
                m = mesh.make_mesh(1, 1)
                mesh.shard_train_state(state, m, tensor_parallel=False)
            t = time.perf_counter()
            metrics = completion.train_step(state, batch, draws, cfg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            runs[name] = (float(metrics["loss"]),
                          [p.detach().clone() for p in state.parameters()],
                          secs, type(state.module("net_g")).__name__)
            del state
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    (l0, p0, s0, w0), (l1, p1, s1, w1) = runs["plain"], runs["mesh"]
    diff = torch.cat([(a - b).abs().flatten() for a, b in zip(p0, p1)])
    frac = float((diff <= 1e-6).float().mean())
    worst = float(diff.max())
    print(f"mesh step (1-rank NCCL group, {w1}; the collectives run but a "
          f"1-card machine cannot show one across cards, the CPU tests "
          f"with gloo hold 2 and 2 x 2 ranks to the 1-rank step): loss "
          f"{l1:.6f} against {l0:.6f} without the group ({w0}); "
          f"parameters within 1e-6: {frac:.6f}, max |diff| {worst:.3g}; "
          f"step {s1 * 1e3:.1f} ms against {s0 * 1e3:.1f} ms (one cold "
          f"step each); on {card}", flush=True)
    lr = cfg.learning_rate
    if not (abs(l1 - l0) <= 1e-3 * abs(l0) and frac >= 0.999
            and worst <= 2 * lr + 1e-6):
        raise AssertionError(f"mesh step: loss {l1} vs {l0}, within 1e-6 "
                             f"{frac}, max {worst}")


def profile_call(call, wall_s):
    """One pipeline call under torch.profiler: host time of each stage
    range (rp.*) and the device time of the kernels launched inside it,
    the device's busy and idle share against the unprofiled wall time, and
    the kernels with the most device time.  The profiler slows the host,
    so host times read high; device times do not."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e, total=False):
        name = "device_time_total" if total else "self_device_time_total"
        v = getattr(e, name, None)
        return getattr(e, name.replace("device", "cuda"), 0) if v is None \
            else v

    def on_device(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    # CPU-side ranges; their GPU-side twins only span the range
    ranges = [e for e in events
              if e.key.startswith("rp.") and not on_device(e)]
    for e in sorted(ranges, key=lambda e: -e.cpu_time_total):
        print(f"stage {e.key}: {e.count} ranges, host "
              f"{e.cpu_time_total / 1e3:.1f} ms (profiled), device "
              f"{dev_us(e, True) / 1e3:.1f} ms", flush=True)
    kernels = [e for e in events if on_device(e)
               and not e.key.startswith("rp.")]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    if busy_ms == 0:
        print("device time: not measured (no device events)", flush=True)
        return
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"device busy {busy_ms:.1f} ms of {wall_s * 1e3:.1f} ms per call: "
          f"idle share {1 - busy_ms / (wall_s * 1e3):.3f}; "
          f"{sum(e.count for e in kernels)} kernels, {launches} "
          f"cudaLaunchKernel calls", flush=True)
    for e in sorted(kernels, key=lambda e: -dev_us(e))[:8]:
        print(f"  {dev_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:70]}",
              flush=True)


def check_poses(T):
    import torch
    if tuple(T.shape) != (B, 4, 4):
        raise AssertionError(f"poses of shape {tuple(T.shape)}")
    if not bool(torch.isfinite(T).all()):
        raise AssertionError("non-finite poses")
    R = T[:, :3, :3]
    eye = torch.eye(3, device=T.device)
    dev = float((R @ R.transpose(-1, -2) - eye).abs().max())
    if dev > 1e-3:
        raise AssertionError(f"R not orthonormal: {dev}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from relativepose_tpu_torch.pipeline.recurrent import set_numerics
    set_numerics()

    ph = Phases()
    card = ph.run("1 device", phase_device)
    ph.run("2 build", phase_build)
    W, k1 = ph.run("3 pair_weight_matrix", phase_pair_weight)
    k2 = ph.run("4 power_iteration", phase_power, W)
    del W
    launches = {}
    data = ph.run("5a synthetic pairs", make_pairs, "suncg")
    profiled, trans_5b = ph.run("5b pipeline", phase_pipeline, data, card,
                                launches)
    scannet = ph.run("5c scannet pairs", make_pairs, "scannet")
    profiled_sc = ph.run("5c scannet pipeline", phase_scannet, scannet, card,
                         launches)
    ph.run("5d options", phase_options, data, trans_5b, launches)
    # 5g evaluates 5e's held-out pairs again: render them once
    pairs = tempfile.mkdtemp(prefix="chip_smoke_pairs_")
    cache = os.environ.get("RPTPU_SYNTH_CACHE")
    os.environ["RPTPU_SYNTH_CACHE"] = pairs
    try:
        ph.run("5e evaluate", phase_evaluate, launches)
        ph.run("5g trained weights", phase_trained, card, launches)
    finally:
        if cache is None:
            os.environ.pop("RPTPU_SYNTH_CACHE")
        else:
            os.environ["RPTPU_SYNTH_CACHE"] = cache
        shutil.rmtree(pairs, ignore_errors=True)
    profiled_tr = ph.run("6a training steps", phase_train_steps, card)
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        comp = ph.run("6b training CLIs", phase_train_clis, card, work)
        ft_ckpt = ph.run("6c pose fine-tuning", phase_finetune, card, comp,
                         data, work, launches)
        ph.run("6d sigma tuning", phase_tune_sigma, card, ft_ckpt, work,
               launches)
        ph.run("7a classical baselines", phase_classical, card)
        ph.run("7b torch checkpoints", phase_torch_checkpoint, card, work,
               launches)
        ph.run("7c mesh", phase_mesh, card)
        ph.run("8 orbax checkpoints", phase_orbax, card, launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # last: the profiler can leave the host slower for later calls
    ph.run("5f profile suncg", profile_call, *profiled)
    ph.run("5f profile scannet", profile_call, *profiled_sc)
    ph.run("5f profile completion step", profile_call, *profiled_tr)
    for k in (k1, k2):
        k["launches"] = launches.get(k["name"], 0)
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(card)
    print(json.dumps({"kernels": [{o: k[o] for o in order}
                                  for k in (k1, k2)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
