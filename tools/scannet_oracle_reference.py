"""Reference rotation and translation errors of the JAX package's ScanNet
pipeline with ground-truth (oracle) completion, on the 16 synthetic pairs
that `chip_smoke.py` phase 5c runs through the port.

    JAX_PLATFORMS=cpu python tools/scannet_oracle_reference.py [--key_offset K]

Pairs `make_pair(i, "scannet", max_baseline=0.5)` for i < 16; 3 steps, the
kinect mask, 21 classes, `KeypointConfig()` (C = 1720), `SolverStaticConfig(
power_iters=30)`, default `SolverHyperParams()`, key `PRNGKey(i + K)` per
pair (K = 0 for the recorded reference; other K show how far the median
moves with the keypoint draws alone), 4 pairs per jitted call.  Prints the
per-pair errors and one JSON line with the medians.  The port's run draws
other keypoints, so its median is compared with this one within a margin,
not exactly.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from relativepose_tpu.core.rotation import angular_distance  # noqa: E402
from relativepose_tpu.data import synthetic  # noqa: E402
from relativepose_tpu.match.keypoints import KeypointConfig  # noqa: E402
from relativepose_tpu.match.solver import (  # noqa: E402
    SolverHyperParams,
    SolverStaticConfig,
)
from relativepose_tpu.pipeline import recurrent  # noqa: E402
from relativepose_tpu.pipeline.oracle import (  # noqa: E402
    make_oracle_completion_fn,
)

N_PAIRS, CHUNK = 16, 4


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--key_offset", type=int, default=0)
    key_offset = p.parse_args().key_offset
    jax.config.update("jax_platforms", "cpu")
    cfg = recurrent.PipelineConfig(
        dataset="scannet", mask_method="kinect", alter_steps=3, snumclass=21,
        keypoints=KeypointConfig(), solver=SolverStaticConfig(power_iters=30))
    hp = SolverHyperParams()

    def one(ds, dt, key):
        fn = make_oracle_completion_fn(ds, dt, cfg.layout)
        return recurrent.estimate_pose_via_completion(fn, ds, dt, key, hp,
                                                      cfg)

    run = jax.jit(jax.vmap(one))
    rot, trans = [], []
    t0 = time.time()
    for lo in range(0, N_PAIRS, CHUNK):
        pairs = [synthetic.make_pair(i, "scannet", max_baseline=0.5)
                 for i in range(lo, lo + CHUNK)]
        ds, dt = ({k: jnp.asarray(np.stack([p[v][k] for p in pairs]))
                   for k in ("rgb", "norm", "depth", "segm", "rgb_full")}
                  for v in (0, 1))
        keys = jnp.stack([jax.random.PRNGKey(i + key_offset)
                          for i in range(lo, lo + CHUNK)])
        T = np.asarray(run(ds, dt, keys))
        for b, p in enumerate(pairs):
            T_gt = p[2]
            rot.append(float(angular_distance(jnp.asarray(T[b, :3, :3]),
                                              jnp.asarray(T_gt[:3, :3]))))
            trans.append(float(np.linalg.norm(T[b, :3, 3] - T_gt[:3, 3])))
            print(f"pair {lo + b}: rotation {rot[-1]:.4f} deg, "
                  f"translation {trans[-1]:.4f}", flush=True)
    print(json.dumps({"pairs": N_PAIRS, "key_offset": key_offset,
                      "rot_median_deg": float(np.median(rot)),
                      "trans_median": float(np.median(trans)),
                      "seconds": time.time() - t0}))


if __name__ == "__main__":
    main()
