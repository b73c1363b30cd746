"""Helpers shared by the tests that hold relativepose_tpu_torch against
relativepose_tpu: numpy inputs go to both packages, and the JAX package's
random draws are handed to the port."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.match import keypoints as jkp
from relativepose_tpu.match.keypoints import KeypointConfig as JKeypoints
from relativepose_tpu.match.keypoints import detect_observed, rgb_to_gray
from relativepose_tpu.match.solver import SolverHyperParams as JHyper
from relativepose_tpu.match.solver import SolverStaticConfig as JSolver
from relativepose_tpu.pipeline import recurrent as jrec
from relativepose_tpu.pipeline.oracle import make_oracle_completion_fn as jor
from relativepose_tpu_torch.data import synthetic
from relativepose_tpu_torch.match.keypoints import KeypointConfig
from relativepose_tpu_torch.match.keypoints import KeypointDraws
from relativepose_tpu_torch.match.solver import (
    SolverHyperParams,
    SolverStaticConfig,
)
from relativepose_tpu_torch.pipeline import recurrent as trec
from relativepose_tpu_torch.pipeline.oracle import make_oracle_completion_fn


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one CPU thread in the test module that imports this
    fixture, its module fixtures included.  The tier-1 run puts 6 test
    workers on the machine's 8 cores, and torch's thread pool in each
    oversubscribes them: the pipeline's small ops ran 20x slower than
    alone (one thread costs them 1.4x alone), and the whole tier-1 run
    took 1297 s with torch's default threads against 693 s with
    OMP_NUM_THREADS=1 (on an 8-core CPU).  The modules of
    `train/mesh.py`'s spawned ranks keep the default: their ranks set
    their own thread counts."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stack_pairs(dicts):
    """List of per-pair numpy dicts -> dict of [B, ...] numpy arrays."""
    return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]
            if k != "pose"}


def jax_choice(key, valid, n):
    probs = valid.astype(jnp.float32) + 1e-9
    probs = probs / probs.sum()
    return jax.random.choice(key, valid.shape[0], (n,), replace=True,
                             p=probs)


def jax_keypoint_draws(step_key, det_s_valid, det_t_valid, cfg,
                       mask_method="second"):
    """The draws `relativepose_tpu.match.keypoints.build_keypoint_sets`
    makes from `step_key` for one pair, as numpy arrays."""
    keys = jax.random.split(step_key, 6)
    kx, ky = jax.random.split(keys[2])
    _, rnd_valid = jkp.random_unobserved_points(keys[2], cfg.n_random,
                                                mask_method)
    return dict(
        sel_t1=np.asarray(jax_choice(keys[0], det_s_valid, cfg.n_match)),
        sel_s=np.asarray(jax_choice(keys[1], det_t_valid, cfg.n_match)),
        rnd_u=np.stack([np.asarray(jax.random.uniform(kx, (cfg.n_random,))),
                        np.asarray(jax.random.uniform(ky, (cfg.n_random,)))]),
        sel_t2=np.asarray(jax_choice(keys[3], rnd_valid, cfg.n_random)))


def batch_draws(per_pair):
    """List over pairs of draw dicts -> KeypointDraws of [B, ...] tensors."""
    return KeypointDraws(**{k: torch.from_numpy(np.stack([d[k] for d in
                                                          per_pair]))
                            for k in per_pair[0]})


def jax_pipeline_draws(keys, alter_steps, det_s_valid, det_t_valid, cfg,
                       mask_method="second"):
    """Per-step KeypointDraws of the JAX pipeline for pair keys [B, 2]:
    `recurrent.py` splits each pair's key into `alter_steps` step keys.
    det_*_valid: [B, n_detect] JAX detection masks."""
    steps = [[] for _ in range(alter_steps)]
    for b in range(keys.shape[0]):
        for s, sk in enumerate(jax.random.split(keys[b], alter_steps)):
            steps[s].append(jax_keypoint_draws(
                sk, det_s_valid[b], det_t_valid[b], cfg, mask_method))
    return [batch_draws(p) for p in steps]


def flax_f64(net, params, x):
    """A Flax module of the JAX package (SCNet, Resnet18_8s) evaluated in
    f64 on the CPU: parameters and input in f64 under `jax.enable_x64`,
    and the `float32` that `relativepose_tpu/models/blocks.py::
    BatchNorm2d` casts its input to rebound to float64 for the call.
    Without that rebinding its statistics stay f32: the shipped trained
    SCNet's output is then 1.9e-5 relative L2 from the f64 function, as
    far as its f32 output (2.1e-5)."""
    from relativepose_tpu.models import blocks
    f64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                   if not k.startswith("__")})
    f64.float32 = jnp.float64
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(blocks, "jnp", f64)
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        y = net.apply({"params": p64}, jnp.asarray(x, jnp.float64))
        assert y.dtype == jnp.float64
        return np.asarray(y)


def flax_scnet_params(net, seed=0):
    """Parameters for a Flax SCNet from a numpy seed.  The tree's shapes
    come from `jax.eval_shape` (a trace, nothing compiled): kernels
    ~ N(0, 1/fan_in), BatchNorm scale (stored as weight - 1) ~ N(0, 0.02),
    biases ~ N(0, 0.02)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, 160, 640, 16)))["params"]

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.02 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# The pipelines of both packages at the small configuration of
# `__graft_entry__.py`, with alter_steps=2.
SMALL = dict(n_detect=32, n_match=16, n_random=8)
STEPS = 2


def configs(unroll=False, **kw):
    """The small pipeline configuration in both packages."""
    jcfg = jrec.PipelineConfig(alter_steps=STEPS,
                               keypoints=JKeypoints(**SMALL),
                               solver=JSolver(power_iters=5), unroll=unroll,
                               **kw)
    tcfg = trec.PipelineConfig(alter_steps=STEPS,
                               keypoints=KeypointConfig(**SMALL),
                               solver=SolverStaticConfig(power_iters=5), **kw)
    return jcfg, tcfg


def pairs(seeds, dataset="suncg"):
    """Synthetic pairs -> (data_s, data_t, T_gt) of stacked numpy arrays."""
    ps = [synthetic.make_pair(s, dataset, max_baseline=0.5) for s in seeds]
    return (stack_pairs([p[0] for p in ps]), stack_pairs([p[1] for p in ps]),
            np.stack([p[2] for p in ps]))


def run_jax(ds, dt, keys, jcfg, scnet_fn_of, hp=None):
    """Per-pair JAX runs -> (final poses, step poses, detection masks)."""
    finals, steps, det_s, det_t = [], [], [], []
    for b in range(keys.shape[0]):
        dj = {k: jnp.asarray(v[b]) for k, v in ds.items()}
        dtj = {k: jnp.asarray(v[b]) for k, v in dt.items()}
        T, st = jrec.estimate_pose_via_completion(
            scnet_fn_of(dj, dtj), dj, dtj, keys[b], hp or JHyper(), jcfg,
            return_step_poses=True)
        finals.append(np.asarray(T))
        steps.append(np.asarray(st))
        det_s.append(jax_detection_mask(dj, jcfg))
        det_t.append(jax_detection_mask(dtj, jcfg))
    return (np.stack(finals), np.stack(steps), np.stack(det_s),
            np.stack(det_t))


def jax_detection_mask(d, jcfg):
    """The valid mask of the JAX pipeline's detections of one view (a dict
    of JAX arrays of one pair), as numpy."""
    _, mask = jrec.make_view(d["rgb"], d["norm"], d["depth"],
                             jcfg.mask_method)
    gray = None if "rgb_full" not in d else \
        rgb_to_gray(d["rgb_full"] * 255.0)
    return np.asarray(detect_observed(mask * d["rgb"] * 255.0,
                                      jcfg.keypoints, gray)[1])


def run_oracle_both(ds, dt, key_seed, jcfg, tcfg, hp_j=None, hp_t=None):
    """The oracle pipeline in both packages on the same draws ->
    (JAX step poses, port final poses, port step poses, draws)."""
    keys = jax.random.split(jax.random.PRNGKey(key_seed), len(ds["rgb"]))
    _, steps_j, det_s, det_t = run_jax(
        ds, dt, keys, jcfg, lambda a, b: jor(a, b, jcfg.layout), hp_j)
    draws = jax_pipeline_draws(keys, jcfg.alter_steps, det_s, det_t,
                               jcfg.keypoints, jcfg.mask_method)
    dev_s, dev_t = trec.as_pair_batch(ds, "cpu"), trec.as_pair_batch(dt, "cpu")
    T, steps_t = trec.estimate_pose_via_completion(
        make_oracle_completion_fn(dev_s, dev_t, tcfg.layout), ds, dt,
        hp_t or SolverHyperParams(), tcfg, draws=draws,
        return_step_poses=True, device="cpu")
    return steps_j, T, steps_t, draws


def jax_corres_draws(keys, depth_s, dataset):
    """(q_idx, pick_u) that `relativepose_tpu.data.pipeline.
    dense_correspondences` draws from each key of keys [B]; depth_s:
    [B, H, W] numpy depth of each pair's view 0 (masked queries)."""
    from relativepose_tpu import config as jconfig
    from relativepose_tpu.core import skybox as jsky
    from relativepose_tpu.data import pipeline as jpipe
    prm = jpipe.CORRES_PARAMS[jconfig.canonical_dataset(dataset)]
    q, u = [], []
    for b in range(keys.shape[0]):
        k1, k2 = jax.random.split(keys[b])
        if prm["masked_queries"]:
            _, val = jsky.pano_to_pointcloud(jnp.asarray(depth_s[b]), dataset)
            pq = val.astype(jnp.float32) + 1e-9
            q.append(jax.random.choice(k1, val.shape[0], (prm["n_query"],),
                                       replace=True, p=pq / pq.sum()))
        else:
            q.append(jax.random.randint(k1, (prm["n_query"],), 0,
                                        depth_s[b].size))
        u.append(jax.random.uniform(k2, (prm["n_corres"],)))
    return (torch.from_numpy(np.stack(q)).long(),
            torch.from_numpy(np.stack(u)))


def jax_pair_draws(keys, depth_s, dataset):
    """The draws `relativepose_tpu.data.pipeline.assemble_pair_batch` makes
    from each pair key of keys [B], as the port's `PairDraws`."""
    from relativepose_tpu_torch.data.pipeline import PairDraws
    splits = [jax.random.split(keys[b], 3) for b in range(keys.shape[0])]
    q_idx, pick_u = jax_corres_draws(jnp.stack([s[0] for s in splits]),
                                     depth_s, dataset)
    axis, angle, trans = [], [], []
    for _, k_r0, k_r1 in splits:
        per = []
        for kr in (k_r0, k_r1):
            ka, kt = jax.random.split(kr)
            kax, kan = jax.random.split(ka)
            per.append((jax.random.uniform(kax, (3,)),
                        jax.random.normal(kan, ()),
                        jax.random.normal(kt, (3,))))
        axis.append(np.stack([np.asarray(p[0]) for p in per]))
        angle.append(np.stack([np.asarray(p[1]) for p in per]))
        trans.append(np.stack([np.asarray(p[2]) for p in per]))
    return PairDraws(q_idx, pick_u, *(torch.from_numpy(np.stack(x))
                                      for x in (axis, angle, trans)))


def synthetic_pair_arrays(seeds, dataset):
    """[B, 2, ...] numpy rgb / norm / depth / segm / pose of synthetic
    pairs (no kinect frames)."""
    ps = [synthetic.make_pair(s, dataset, max_baseline=0.5,
                              full_frames=False) for s in seeds]
    return {k: np.stack([np.stack([p[0][k], p[1][k]]) for p in ps])
            for k in ("rgb", "norm", "depth", "segm", "pose")}
