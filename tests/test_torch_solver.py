"""The pose solver and its two kernels' plain versions, against
relativepose_tpu on the CPU (the CUDA kernels are held against the plain
versions in tests/test_torch_gpu.py).

Tolerances: W entries are products of exponentials below 1, and sums in
another order move them by ~1e-7, so 1e-6 holds the port to the JAX
package's XLA build; against the Pallas kernel (polynomial arccos, no
1e-20 under the square root) the bound is the 5e-5 that the JAX package
holds that kernel to, with counts within 2.  Poses are held to 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.match import solver as jsol
from relativepose_tpu.ops.pallas_kernels import (
    pair_weight_matrix_vmem,
    power_iteration_vmem,
)
from relativepose_tpu_torch.match import solver as tsol
from relativepose_tpu_torch.ops import kernels
from torch_parity import one_torch_thread  # noqa: F401

METHODS = ["horn87", "irls", "spectral", "irls+sm"]


def t(x):
    return torch.from_numpy(np.array(x))


def components(rng, C):
    """Correspondence components from a numpy seed (the JAX package's
    Pallas test inputs)."""
    ps = rng.randn(C, 3).astype(np.float32)
    pt = (ps + 0.03 * rng.randn(C, 3)).astype(np.float32)
    ns = rng.randn(C, 3)
    ns = (ns / np.linalg.norm(ns, axis=1, keepdims=True)).astype(np.float32)
    nt = rng.randn(C, 3).astype(np.float32)
    f = rng.rand(C).astype(np.float32)
    obs = np.where(rng.rand(C) > 0.3, 1.0, 0.99).astype(np.float32)
    cvalid = rng.rand(C) > 0.1
    return ps, pt, ns, nt, f, obs * obs, cvalid


def test_pair_weight_matrix_matches_xla_build(rng):
    comps = components(rng, 300)
    W0, c0 = jsol.pair_weight_matrix(*map(jnp.asarray, comps),
                                     jsol.SolverHyperParams())
    W1, c1 = kernels.pair_weight_matrix_plain(
        *[t(a)[None] for a in comps], tsol.SolverHyperParams())
    np.testing.assert_allclose(np.asarray(W0), W1[0].numpy(), atol=1e-6)
    for k in c0:
        assert int(c0[k]) == int(c1[k][0]), k


@pytest.mark.parametrize("c", [1, 2, 65, 129, 300])
def test_pair_weight_matrix_matches_pallas_kernel(rng, c):
    """C=300 is not a multiple of any tile (the TPU's 256, the CUDA
    kernel's 64); 1, 2, 65 and 129 are the CUDA kernel's tile edges (one
    entry, one pair, one past a tile, one past two).  The Pallas kernel
    runs in interpret mode."""
    comps = components(rng, c)
    W0, c0 = pair_weight_matrix_vmem(*map(jnp.asarray, comps),
                                     jsol.SolverHyperParams(),
                                     interpret=True)
    W1, c1 = kernels.pair_weight_matrix(*[t(a)[None] for a in comps],
                                        tsol.SolverHyperParams())
    assert W1.shape == (1, c, c)
    np.testing.assert_allclose(np.asarray(W0), W1[0].numpy(), atol=5e-5)
    for k in c0:
        assert abs(int(c0[k]) - int(c1[k][0])) <= 2, k
    assert torch.equal(W1, W1.transpose(-1, -2))
    assert not torch.diagonal(W1, dim1=-2, dim2=-1).any()


def test_pair_weight_matrix_batches(rng):
    comps = [components(np.random.RandomState(s), 64) for s in range(3)]
    batched = [t(np.stack([c[i] for c in comps])) for i in range(7)]
    W, counts = kernels.pair_weight_matrix(*batched, tsol.SolverHyperParams())
    for b, c in enumerate(comps):
        W1, c1 = kernels.pair_weight_matrix(*[t(a)[None] for a in c],
                                            tsol.SolverHyperParams())
        torch.testing.assert_close(W[b], W1[0], rtol=0, atol=1e-7)
        for k in counts:
            assert int(counts[k][b]) == int(c1[k][0])


@pytest.mark.parametrize("case", ["random", "h0", "W0"])
def test_power_iteration_matches_jax(rng, case):
    """The plain loop against `power_iteration_vmem`'s CPU branch.  With
    h = 0 or W = 0 every step has norm 0, so both keep v = 1."""
    comps = components(rng, 200)
    W, _ = jsol.pair_weight_matrix(*map(jnp.asarray, comps),
                                   jsol.SolverHyperParams())
    h = (50.0 * rng.rand(200)).astype(np.float32)
    if case == "h0":
        h = np.zeros_like(h)
    if case == "W0":
        W = jnp.zeros_like(W)
    uj = np.asarray(power_iteration_vmem(W, jnp.asarray(h), 30))
    n0 = kernels.POWER_ITER.launches
    ut = kernels.power_iteration(t(W)[None], t(h)[None], 30)[0].numpy()
    np.testing.assert_allclose(uj, ut, atol=1e-6)
    if case != "random":
        np.testing.assert_array_equal(ut, np.ones(200, np.float32))
    assert kernels.POWER_ITER.launches == n0  # the CPU never launches


def test_wrappers_refuse_non_cuda_devices(rng):
    """No fallback: a tensor that is neither on the CPU nor on CUDA
    raises instead of running the plain version."""
    comps = [t(a)[None].to("meta") for a in components(rng, 8)]
    with pytest.raises(ValueError):
        kernels.pair_weight_matrix(*comps, tsol.SolverHyperParams())
    with pytest.raises(ValueError):
        kernels.power_iteration(torch.zeros(1, 8, 8, device="meta"),
                                torch.zeros(1, 8, device="meta"), 3)


def _keypoint_sets(rng, K=40, F=8, angle=0.4):
    pc = rng.randn(K, 3).astype(np.float32)
    n = rng.randn(K, 3)
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    feat = (30 * rng.randn(K, F)).astype(np.float32)
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    tr = np.array([0.2, -0.1, 0.3], np.float32)
    w = np.where(rng.rand(K) > 0.3, 1.0, 0.99).astype(np.float32)
    valid = rng.rand(K) > 0.1
    ds = dict(pc=pc, normal=n, feat=feat, weight=w, valid=valid)
    dt = dict(pc=pc @ R.T + tr, normal=n @ R.T,
              feat=(feat + 0.1 * rng.randn(K, F)).astype(np.float32),
              weight=w, valid=valid)
    return ds, dt


def _both(ds, dt, method, use_pallas):
    Tj, sj = jsol.estimate_relative_pose(
        {k: jnp.asarray(v) for k, v in ds.items()},
        {k: jnp.asarray(v) for k, v in dt.items()},
        jsol.SolverHyperParams(),
        jsol.SolverStaticConfig(method=method, power_iters=10,
                                use_pallas=use_pallas), return_score=True)
    Tt, st = tsol.estimate_relative_pose(
        {k: t(v)[None] for k, v in ds.items()},
        {k: t(v)[None] for k, v in dt.items()},
        tsol.SolverHyperParams(),
        tsol.SolverStaticConfig(method=method, power_iters=10,
                                use_pallas=use_pallas), return_score=True)
    return np.asarray(Tj), float(sj), Tt[0].numpy(), float(st[0])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_estimate_relative_pose(rng, method, use_pallas):
    ds, dt = _keypoint_sets(rng)
    Tj, sj, Tt, st = _both(ds, dt, method, use_pallas)
    np.testing.assert_allclose(Tj, Tt, atol=1e-4)
    assert abs(sj - st) < 1e-6 and st > 0.5


@pytest.mark.parametrize("method", METHODS)
def test_estimate_relative_pose_does_not_depend_on_the_batch(rng, method):
    """Each pair's pose in a batch of 3 equals, bit for bit, its pose
    solved alone: a sharded evaluation gives what one rank gives.  Before
    `_rowsum_rank1` took W u from a two-column product, irls+sm and
    spectral moved by up to 2.6e-6 here (f32, K 40-400)."""
    sets = [_keypoint_sets(rng, K=120, angle=a) for a in (0.2, 0.4, 0.6)]

    def batch(side, idx):
        return {k: torch.from_numpy(np.stack([sets[i][side][k]
                                              for i in idx]))
                for k in sets[0][0]}

    cfg = tsol.SolverStaticConfig(method=method, power_iters=10)
    hp = tsol.SolverHyperParams()
    T = tsol.estimate_relative_pose(batch(0, [0, 1, 2]),
                                    batch(1, [0, 1, 2]), hp, cfg)
    for i in range(3):
        alone = tsol.estimate_relative_pose(batch(0, [i]), batch(1, [i]),
                                            hp, cfg)
        assert torch.equal(T[i], alone[0]), (i, (T[i] - alone[0]).abs())


def test_descriptor_affinity(rng):
    fs, ft = rng.randn(2, 30, 8).astype(np.float32) / 10
    ws = np.where(rng.rand(30) > 0.5, 1.0, 0.99).astype(np.float32)
    valid = rng.rand(30) > 0.2
    a = jsol.descriptor_affinity(*map(jnp.asarray, (fs, ft, ws, ws, valid,
                                                    valid)), 0.01)
    b = tsol.descriptor_affinity(*[t(x)[None] for x in (fs, ft, ws, ws,
                                                        valid, valid)], 0.01)
    np.testing.assert_allclose(np.asarray(a), b[0].numpy(), atol=1e-6)


class TestEarlyOuts:
    def test_too_few_keypoints(self, rng):
        ds, dt = _keypoint_sets(rng)
        ds["valid"][:] = False
        ds["valid"][:2] = True
        Tj, sj, Tt, st = _both(ds, dt, "irls+sm", False)
        np.testing.assert_array_equal(Tt, np.eye(4))
        np.testing.assert_array_equal(Tj, Tt)
        assert sj == st == 0.0

    def test_no_consistent_pairs(self, rng):
        ds, dt = _keypoint_sets(rng)
        dt["pc"] = (rng.randn(*dt["pc"].shape) * 10).astype(np.float32)
        Tj, sj, Tt, st = _both(ds, dt, "irls+sm", False)
        np.testing.assert_array_equal(Tt, np.eye(4))
        np.testing.assert_array_equal(Tj, Tt)

    def test_all_invalid(self, rng):
        ds, dt = _keypoint_sets(rng)
        ds["valid"][:] = False
        dt["valid"][:] = False
        _, _, Tt, st = _both(ds, dt, "irls+sm", True)
        np.testing.assert_array_equal(Tt, np.eye(4))

    def test_batch_mixes_early_out_and_solve(self, rng):
        (ds1, dt1), (ds2, dt2) = _keypoint_sets(rng), _keypoint_sets(rng)
        ds2["valid"][:] = False
        T = tsol.estimate_relative_pose(
            {k: t(np.stack([ds1[k], ds2[k]])) for k in ds1},
            {k: t(np.stack([dt1[k], dt2[k]])) for k in dt1},
            tsol.SolverHyperParams())
        np.testing.assert_array_equal(T[1].numpy(), np.eye(4))
        assert not np.allclose(T[0].numpy(), np.eye(4))


def test_deferred_options_raise(rng):
    """Every solver option is ported now; an option value the solver does
    not know (an unknown method) raises ValueError in both packages."""
    ds, dt = _keypoint_sets(rng)
    with pytest.raises(ValueError):
        jsol.estimate_relative_pose(
            {k: jnp.asarray(v) for k, v in ds.items()},
            {k: jnp.asarray(v) for k, v in dt.items()},
            jsol.SolverHyperParams(), jsol.SolverStaticConfig(method="lsq"))
    with pytest.raises(ValueError):
        tsol.estimate_relative_pose(
            {k: t(v)[None] for k, v in ds.items()},
            {k: t(v)[None] for k, v in dt.items()},
            tsol.SolverHyperParams(), tsol.SolverStaticConfig(method="lsq"))


def _outlier_scene(rng, kind):
    """Keypoint sets with target position errors, as the JAX package's
    refit / trans-refine tests build them: 'noise' moves half the targets
    by ~3.5 cm, 'cluster' moves a third by a coherent ~0.7 m bias."""
    ds, dt = _keypoint_sets(rng, K=48)
    if kind == "noise":
        dt["pc"][:24] += (rng.randn(24, 3) * 0.035).astype(np.float32)
    else:
        dt["pc"][:16] += (np.array([0.5, -0.35, 0.25]) +
                          rng.randn(16, 3) * 0.02).astype(np.float32)
    return ds, dt


@pytest.mark.parametrize("method, refit, trans, kind", [
    ("irls+sm", 2, 0, "noise"),
    ("horn87", 0, 8, "cluster"),
    ("irls+sm", 0, 8, "cluster"),
    ("spectral", 3, 3, "noise"),
])
def test_refit_and_trans_refine_match_jax(rng, method, refit, trans, kind):
    """refit_rounds / trans_refine_rounds against the JAX package, poses
    to 1e-4 (their Horn solves and vote means sum in another order), on
    two pairs at once.  Like the JAX tests: trans_refine leaves R as the
    fit left it, and on the biased cluster it moves t toward the truth
    (mirrors tests/test_match_solver.py:93 and :122)."""
    scenes = [_outlier_scene(rng, kind) for _ in range(2)]
    cfg = dict(method=method, power_iters=10, top_k=3)
    jcfg = jsol.SolverStaticConfig(refit_rounds=refit,
                                   trans_refine_rounds=trans, **cfg)
    tcfg = tsol.SolverStaticConfig(refit_rounds=refit,
                                   trans_refine_rounds=trans, **cfg)
    T, score = tsol.estimate_relative_pose(
        {k: t(np.stack([s[0][k] for s in scenes])) for k in scenes[0][0]},
        {k: t(np.stack([s[1][k] for s in scenes])) for k in scenes[0][1]},
        tsol.SolverHyperParams(), tcfg, return_score=True)
    base = tsol.estimate_relative_pose(
        {k: t(np.stack([s[0][k] for s in scenes])) for k in scenes[0][0]},
        {k: t(np.stack([s[1][k] for s in scenes])) for k in scenes[0][1]},
        tsol.SolverHyperParams(), tsol.SolverStaticConfig(**cfg))
    for b, (ds, dt) in enumerate(scenes):
        Tj, sj = jsol.estimate_relative_pose(
            {k: jnp.asarray(v) for k, v in ds.items()},
            {k: jnp.asarray(v) for k, v in dt.items()},
            jsol.SolverHyperParams(), jcfg, return_score=True)
        np.testing.assert_allclose(np.asarray(Tj), T[b].numpy(), atol=1e-4)
        assert abs(float(sj) - float(score[b])) < 1e-6
    assert not torch.allclose(T, base)
    if refit == 0:
        torch.testing.assert_close(T[:, :3, :3], base[:, :3, :3], rtol=0,
                                   atol=0)
    if kind == "cluster" and method == "horn87":
        # the refined pose fits the keypoints the cluster left unmoved
        for b, (ds, dt) in enumerate(scenes):
            def err(M):
                return np.linalg.norm(M[:3, :3] @ ds["pc"][16:].T
                                      + M[:3, 3:4] - dt["pc"][16:].T)
            assert err(T[b].numpy()) < err(base[b].numpy())


def test_static_config_fields_match():
    import dataclasses
    fj = [(f.name, f.default) for f in
          dataclasses.fields(jsol.SolverStaticConfig)]
    ft = [(f.name, f.default) for f in
          dataclasses.fields(tsol.SolverStaticConfig)]
    assert fj == ft
