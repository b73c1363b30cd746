"""Adam in the training steps: `state.OptaxAdam` against `torch.optim.Adam`.

The feature and completion trainers step `torch.optim.Adam`; pose
fine-tuning steps `OptaxAdam`, whose updates equal optax's.  This times
the feature and the completion step of `chip_smoke.py`'s phase 6a (full
width, batch 8 pairs, bf16 compute, 16 resident synthetic suncg pairs)
with each optimizer, on one fixed batch and fixed draws, in the
order OptaxAdam, torch, torch, OptaxAdam, so that a drift of the card's
clock falls on both.  Each run starts from the same seeded state.  Prints,
per trainer and optimizer, ms per full step and per optimizer step alone
(CUDA events, after one warm-up) and the card's name and power limit.

    python -m relativepose_tpu_torch.train.bench_adam [--reps 5]
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from relativepose_tpu_torch.data import datasets as dsets
from relativepose_tpu_torch.data import device_store as dstore
from relativepose_tpu_torch.train import completion, feature
from relativepose_tpu_torch.train.state import OptaxAdam

BATCH = 8


def cuda_ms(fn, reps):
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


def time_trainer(name, make_state, step, reps):
    for kind in ("OptaxAdam", "torch.optim.Adam", "torch.optim.Adam",
                 "OptaxAdam"):
        state = make_state()
        group = state.optimizer.param_groups[0]
        adam = OptaxAdam if kind == "OptaxAdam" else torch.optim.Adam
        state.optimizer = adam(state.parameters(), lr=group["lr"],
                               betas=group["betas"], eps=group["eps"])
        ms = cuda_ms(lambda: step(state), reps)
        ms_opt = cuda_ms(state.optimizer.step, reps)
        print(f"{name} step with {kind}: {ms:.3f} ms per step, "
              f"{ms_opt:.3f} ms per optimizer step alone ({reps} after 1 "
              f"warm-up, CUDA events)", flush=True)
        del state


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    store = dstore.DeviceStore(
        dsets.SyntheticPairs("suncg", n=2 * BATCH, seed=0,
                             full_frames=False),
        device="cuda", with_full_frames=False)
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = dstore.gather_batch(store.arrays,
                                torch.arange(BATCH, device="cuda"), "suncg",
                                generator=gen)

    fcfg = feature.FeatureTrainConfig(dtype=torch.bfloat16)
    fdraws = feature.draw_negatives(fcfg, batch, gen)
    time_trainer("feature", lambda: feature.init_state(fcfg, "cuda", seed=0),
                 lambda st: feature.train_step(st, batch, fdraws, fcfg),
                 args.reps)

    ccfg = completion.CompletionTrainConfig(dtype=torch.bfloat16)
    cdraws = completion.draw(ccfg, batch, gen)
    net_f = feature.init_state(fcfg, "cuda", seed=0).models["net_f"]
    time_trainer("completion",
                 lambda: completion.init_state(ccfg, "cuda", seed=0,
                                               net_f=net_f),
                 lambda st: completion.train_step(st, batch, cdraws, ccfg),
                 args.reps)


if __name__ == "__main__":
    main()
