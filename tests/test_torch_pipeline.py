"""The recurrent pipeline of relativepose_tpu_torch against relativepose_tpu.

The small configuration of `__graft_entry__.py` (n_detect=32, n_match=16,
n_random=8, power_iters=5) with alter_steps=2, on synthetic suncg pairs,
with ground-truth (oracle) completion and with a small SCNet (ngf=8, f32,
Flax weights converted in memory).  The port gets the JAX package's
random draws, so the keypoints agree and every step's pose must agree:
to 1e-4 with the oracle, and to 1e-3 with SCNet, whose f32 convolutions
round differently (module tests: 5e-4 on its outputs) and feed the
descriptor heatmaps.  Solver scores are held to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.match import keypoints as jkp
from relativepose_tpu.match import solver as jsol
from relativepose_tpu.match.solver import SolverHyperParams as JHyper
from relativepose_tpu.models import SCNet as FlaxSCNet
from relativepose_tpu.pipeline import recurrent as jrec
from relativepose_tpu.pipeline.oracle import make_oracle_completion_fn as jor
from relativepose_tpu_torch.match import solver as tsol
from relativepose_tpu_torch.match.keypoints import KeypointConfig
from relativepose_tpu_torch.match.solver import (
    SolverHyperParams,
    SolverStaticConfig,
)
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.models.scnet import SCNet
from relativepose_tpu_torch.pipeline import recurrent as trec
from relativepose_tpu_torch.pipeline.oracle import make_oracle_completion_fn
from torch_parity import one_torch_thread  # noqa: F401
from torch_parity import (
    SMALL,
    STEPS,
    configs,
    flax_scnet_params,
    jax_pipeline_draws,
    pairs,
    run_jax,
)


def test_oracle_pipeline_matches_jax():
    ds, dt, T_gt = pairs([20, 21])
    jcfg, tcfg = configs()
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    Tj, steps_j, det_s, det_t = run_jax(
        ds, dt, keys, jcfg, lambda a, b: jor(a, b, jcfg.layout))
    draws = jax_pipeline_draws(keys, STEPS, det_s, det_t, jcfg.keypoints)
    dev_s, dev_t = trec.as_pair_batch(ds, "cpu"), trec.as_pair_batch(dt, "cpu")
    T, steps_t = trec.estimate_pose_via_completion(
        make_oracle_completion_fn(dev_s, dev_t, tcfg.layout), ds, dt,
        SolverHyperParams(), tcfg, draws=draws, return_step_poses=True,
        device="cpu")
    np.testing.assert_allclose(steps_j, steps_t.numpy(), atol=1e-4)
    np.testing.assert_allclose(Tj, T.numpy(), atol=1e-4)
    # and the pose is right: oracle completion on mild baselines
    assert np.abs(T.numpy()[:, :3, :3] - T_gt[:, :3, :3]).max() < 0.05
    fn = trec.batched_pose_estimator(
        make_oracle_completion_fn(dev_s, dev_t, tcfg.layout), tcfg, "cpu")
    torch.testing.assert_close(fn(ds, dt, SolverHyperParams(), draws=draws),
                               T, rtol=0, atol=0)


def test_small_scnet_pipeline_matches_jax():
    """Each step of the SCNet pipeline, started from the JAX package's
    pose of the step before.  Run free, the two pipelines agree on step 0
    to ~3e-5, and that difference alone reaches other splat pixels and
    other heatmap argmins in step 1: with random SCNet weights the next
    pose then differs entirely, in either package, so each step is held
    to 1e-3 from the same starting pose instead."""
    ds, dt, _ = pairs([22])
    # unrolled steps around a jitted SCNet: quicker on the CPU than
    # compiling the scan with SCNet inside
    jcfg, _ = configs(unroll=True)
    size = (64, 128)
    fnet = FlaxSCNet(ngf=8, internal_size=size)
    params = flax_scnet_params(fnet)
    keys = jax.random.split(jax.random.PRNGKey(4), 1)
    apply = jax.jit(lambda x: fnet.apply({"params": params}, x))
    _, steps_j, det_s, det_t = run_jax(ds, dt, keys, jcfg,
                                       lambda a, b: apply)
    draws = jax_pipeline_draws(keys, STEPS, det_s, det_t, jcfg.keypoints)
    net = convert.load_flax_params(SCNet(ngf=8, internal_size=size), params)
    one = trec.PipelineConfig(alter_steps=1, keypoints=KeypointConfig(**SMALL),
                              solver=SolverStaticConfig(power_iters=5))
    for step in range(STEPS):
        T_init = np.eye(4)[None] if step == 0 else steps_j[:, step - 1]
        with torch.no_grad():
            T = trec.estimate_pose_via_completion(
                trec.make_scnet_fn(net), ds, dt, SolverHyperParams(), one,
                T_init=T_init, draws=[draws[step]], device="cpu")
        np.testing.assert_allclose(steps_j[:, step], T.numpy(), atol=1e-3)
        assert not np.allclose(T.numpy()[0], np.eye(4))


def test_best_score_step_select_and_sigma_table():
    """Per-step sigma tables and the best-score selection with its
    identity gate: a min_score above every score gives the identity."""
    ds, dt, _ = pairs([23])
    dev_s, dev_t = trec.as_pair_batch(ds, "cpu"), trec.as_pair_batch(dt, "cpu")
    hp = SolverHyperParams(sigma_dist=[0.04, 0.05], sigma_feat=(0.01, 0.02))
    out = {}
    for min_score in (0.0, 1.01):
        _, tcfg = configs(step_select="best_score", min_score=min_score)
        out[min_score] = trec.estimate_pose_via_completion(
            make_oracle_completion_fn(dev_s, dev_t, tcfg.layout), ds, dt, hp,
            tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert not np.allclose(out[0.0].numpy(), np.eye(4))
    np.testing.assert_array_equal(out[1.01].numpy()[0], np.eye(4))


def test_best_score_matches_jax():
    """step_select='best_score' with a per-step sigma table on the JAX
    package's draws.  The JAX pipeline runs unrolled and returns each
    step's primitives; its solver on them gives each step's pose and
    score.  The port's step poses and selected pose agree to 1e-4, its
    solver scores those primitives alike (1e-6), and min_score set between
    the two pairs' best scores gates the lower pair to the identity in both
    packages and leaves the other's pose as it was."""
    ds, dt, _ = pairs([27, 28])
    sig = dict(sigma_dist=[0.04, 0.05], sigma_feat=[0.01, 0.012])
    hp_j = JHyper(**{k: jnp.asarray(v, jnp.float32) for k, v in sig.items()})
    hp_t = SolverHyperParams(**sig)
    jcfg, tcfg = configs(unroll=True, step_select="best_score")
    keys = jax.random.split(jax.random.PRNGKey(9), 2)
    solve_j = jax.jit(lambda ps, pt, hp: jsol.estimate_relative_pose(
        ps, pt, hp, jcfg.solver, return_score=True))
    sel_j, steps_j, scores = [], [], []
    for b in range(2):
        dj = {k: jnp.asarray(v[b]) for k, v in ds.items()}
        dtj = {k: jnp.asarray(v[b]) for k, v in dt.items()}
        T, prims = jrec.estimate_pose_via_completion(
            jor(dj, dtj, jcfg.layout), dj, dtj, keys[b], hp_j, jcfg,
            return_primitives=True)
        sel_j.append(np.asarray(T))
        for step, (ps, pt) in enumerate(prims):
            T_s, sj = solve_j(ps, pt, JHyper(**{k: getattr(hp_j, k)[step]
                                                for k in sig}))
            _, st = tsol.estimate_relative_pose(
                *[{k: torch.from_numpy(np.array(v))[None]
                   for k, v in p.items()} for p in (ps, pt)],
                SolverHyperParams(**{k: float(v[step])
                                     for k, v in sig.items()}),
                tcfg.solver, return_score=True)
            assert abs(float(sj) - float(st[0])) < 1e-6
            steps_j.append(np.asarray(T_s))
            scores.append(float(sj))
    steps_j = np.stack(steps_j).reshape(2, -1, 4, 4)
    scores = np.asarray(scores).reshape(2, -1)
    det = [[], []]
    for b in range(2):
        for i, d in enumerate((ds, dt)):
            dj = {k: jnp.asarray(v[b]) for k, v in d.items()}
            _, mask = jrec.make_view(dj["rgb"], dj["norm"], dj["depth"],
                                     "second")
            det[i].append(np.asarray(jkp.detect_observed(
                mask * dj["rgb"] * 255.0, jcfg.keypoints)[1]))
    draws = jax_pipeline_draws(keys, jcfg.alter_steps, np.stack(det[0]),
                               np.stack(det[1]), jcfg.keypoints)
    dev_s, dev_t = trec.as_pair_batch(ds, "cpu"), trec.as_pair_batch(dt, "cpu")

    def run_port(cfg):
        return trec.estimate_pose_via_completion(
            make_oracle_completion_fn(dev_s, dev_t, cfg.layout), ds, dt,
            hp_t, cfg, draws=draws, return_step_poses=True, device="cpu")

    T, steps_t = run_port(tcfg)
    np.testing.assert_allclose(steps_j, steps_t.numpy(), atol=1e-4)
    np.testing.assert_allclose(np.stack(sel_j), T.numpy(), atol=1e-4)
    best = scores.argmax(1)
    np.testing.assert_array_equal(T.numpy(), steps_t.numpy()[[0, 1], best])

    gate = float(np.mean(scores.max(1)))
    low = int(scores.max(1).argmin())
    jg, tg = configs(unroll=True, step_select="best_score", min_score=gate)
    dj = {k: jnp.asarray(v[low]) for k, v in ds.items()}
    dtj = {k: jnp.asarray(v[low]) for k, v in dt.items()}
    Tj_low = jrec.estimate_pose_via_completion(
        jor(dj, dtj, jg.layout), dj, dtj, keys[low], hp_j, jg)
    np.testing.assert_array_equal(np.asarray(Tj_low), np.eye(4))
    Tg = run_port(tg)[0].numpy()
    np.testing.assert_array_equal(Tg[low], np.eye(4))
    np.testing.assert_array_equal(Tg[1 - low], T.numpy()[1 - low])


@pytest.mark.parametrize("kw", [dict(remat=True),
                                dict(remat=True, dataset="scannet",
                                     mask_method="kinect"),
                                dict(remat=True, icp_iters=2)])
def test_options_not_ported_raise(kw):
    """remat, which raised until the training slice, now runs with every
    option: under grad mode the rematerialised steps give the poses of the
    plain run bit for bit, and the same gradient (here in a scalar that
    scales the oracle completion)."""
    ds, dt, _ = pairs([24], kw.get("dataset", "suncg"))
    _, tcfg = configs(**kw)
    _, tcfg0 = configs(**{**kw, "remat": False})
    oracle = make_oracle_completion_fn(trec.as_pair_batch(ds, "cpu"),
                                       trec.as_pair_batch(dt, "cpu"),
                                       tcfg.layout)

    def run(cfg):
        a = torch.ones((), requires_grad=True)
        _, steps = trec.estimate_pose_via_completion(
            lambda x: oracle(x) * a, ds, dt, SolverHyperParams(), cfg,
            generator=torch.Generator().manual_seed(0),
            return_step_poses=True, device="cpu")
        (g,) = torch.autograd.grad(steps.square().sum(), a)
        return steps.detach(), g

    steps1, g1 = run(tcfg)
    steps0, g0 = run(tcfg0)
    torch.testing.assert_close(steps1, steps0, rtol=0, atol=0)
    torch.testing.assert_close(g1, g0, rtol=0, atol=0, equal_nan=True)
