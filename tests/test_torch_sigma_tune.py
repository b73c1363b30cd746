"""tune/sigma.py and cli/tune_sigma.py of relativepose_tpu_torch against
relativepose_tpu, on the CPU.

  * The objective on `TestSigmaTuner._toy_primitives` of the JAX package's
    tests: its value to 2e-2 relative, its gradient in log-sigma to
    1e-2 of the largest entry.  The toy scenes are nearly exact, so the
    value is ~7e-7, a sum of squares of rotation errors of ~3e-4 that f32
    rounding in the 4x4 eigensolver moves: at sigma0 the port's f32 value
    differs from its f64 one by 4e-3 relative (the JAX package's by
    5e-4), the two packages' values differ by up to 9e-3 at the second
    sigma tested, and both packages' f32 gradients differ from the port's
    f64 gradient by up to 4e-3 of its largest entry.
  * The objective on those primitives with noise added, so that its
    value is of order 1e-2: value to 1e-4 relative, gradient to 1e-3.
  * `fd_optimize` on a numpy quadratic: the history equals the JAX
    package's exactly (the same RandomState draws, float64 arithmetic).
  * `grad_optimize` on a quadratic, in torch and in jnp: sigmas equal to
    1e-5 after 120 Adam steps (the port's Adam is optax's arithmetic).
  * The primitive cache of the oracle pipeline against the JAX package's
    on the same draws: positions, normals, descriptors and weights to
    1e-4 (the solver-ready primitives of `test_torch_pipeline.py`), the
    valid masks exactly; a cache file written by either package is read
    by the other's `tune_per_level`.
  * The CLI on the CPU from a cache file, for both methods.
"""


import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.match.solver import SolverHyperParams as JHyper
from relativepose_tpu.match.solver import SolverStaticConfig as JSolver
from relativepose_tpu.pipeline.oracle import make_oracle_completion_fn as jor
from relativepose_tpu.tune import sigma as jst
from relativepose_tpu_torch.cli import tune_sigma
from relativepose_tpu_torch.match.solver import (
    SolverHyperParams,
    SolverStaticConfig,
)
from relativepose_tpu_torch.pipeline.oracle import make_oracle_completion_fn
from relativepose_tpu_torch.tune import sigma as tst
import test_eval_and_utils
from torch_parity import (
    configs,
    jax_detection_mask,
    jax_pipeline_draws,
    pairs,
)
from torch_parity import one_torch_thread  # noqa: F401

SIGMA0 = [0.2615, 0.2615, 0.04, 0.01]
TOY_CFG = dict(top_k=3, power_iters=10)


def toy(rng, n_pairs=4):
    """The JAX package's toy primitives -> (JAX stacked, port stacked,
    R_gt)."""
    prims, rgts = test_eval_and_utils.TestSigmaTuner()._toy_primitives(
        rng, n_pairs=n_pairs)
    prims = [tuple({k: np.asarray(v) for k, v in d.items()} for d in p)
             for p in prims]
    return prims, rgts


def test_objective_and_gradient_match_jax(rng):
    prims, rgts = toy(rng)
    jobj = jst.make_objective(*jst.stack_primitives(prims), jnp.asarray(rgts),
                              JSolver(**TOY_CFG))
    tobj = tst.make_objective(*tst.stack_primitives(prims, "cpu"), rgts,
                              SolverStaticConfig(**TOY_CFG,
                                                 pallas_w_build=False))
    log0 = np.log(np.asarray(SIGMA0, np.float32))
    for log_sig in (log0, log0 + np.float32(0.3)):
        vj, gj = jax.value_and_grad(lambda ls: jobj(jnp.exp(ls)))(
            jnp.asarray(log_sig))
        ls = torch.from_numpy(log_sig).requires_grad_(True)
        vt = tobj(torch.exp(ls))
        vt.backward()
        assert float(vj) > 0
        np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=2e-2)
        gj = np.asarray(gj)
        np.testing.assert_allclose(ls.grad.numpy(), gj, rtol=0,
                                   atol=1e-2 * np.abs(gj).max())
        # and the objective at plain array sigmas
        np.testing.assert_allclose(float(tobj(np.exp(log_sig))), float(vj),
                                   rtol=2e-2)


def noisy_toy(rng, n_pairs=4):
    """The toy primitives with the target views' positions, normals and
    descriptors perturbed (seeded apart from `rng`), so that every pair
    keeps a rotation error of order 1e-2."""
    prims, rgts = toy(rng, n_pairs)
    r = np.random.RandomState(1)
    for _, pt in prims:
        pt["pc"] = pt["pc"] + np.float32(0.05) * r.randn(
            *pt["pc"].shape).astype(np.float32)
        n = pt["normal"] + 0.1 * r.randn(*pt["normal"].shape)
        pt["normal"] = (n / np.linalg.norm(n, axis=-1, keepdims=True)
                        ).astype(np.float32)
        pt["feat"] = pt["feat"] + np.float32(0.5) * r.randn(
            *pt["feat"].shape).astype(np.float32)
    return prims, rgts


def test_noisy_objective_and_gradient_match_jax(rng):
    """The objective away from the exact toy scenes (value ~5e-2 and
    ~2e-2), at sigma0 and at a sigma whose four entries all move: value
    to 1e-4 relative, gradient in log-sigma to 1e-3 of its largest entry
    (measured: 2.4e-5 and 1.2e-5 of the value, 6e-6 and 9e-6 of the
    gradient).  Stronger noise (descriptor noise 1.0) reaches points where
    the JAX package's f32 solver picks another hypothesis for a pair than
    its own f64 evaluation does, and its gradient is NaN; the port's f32
    and f64 agree with that f64 evaluation there."""
    prims, rgts = noisy_toy(rng)
    jobj = jst.make_objective(*jst.stack_primitives(prims), jnp.asarray(rgts),
                              JSolver(**TOY_CFG))
    tobj = tst.make_objective(*tst.stack_primitives(prims, "cpu"), rgts,
                              SolverStaticConfig(**TOY_CFG,
                                                 pallas_w_build=False))
    log0 = np.log(np.asarray(SIGMA0, np.float32))
    step = np.asarray([0.3, -0.2, 0.1, 0.25], np.float32)
    for log_sig in (log0, log0 + step):
        vj, gj = jax.value_and_grad(lambda ls: jobj(jnp.exp(ls)))(
            jnp.asarray(log_sig))
        ls = torch.from_numpy(log_sig).requires_grad_(True)
        vt = tobj(torch.exp(ls))
        vt.backward()
        assert float(vj) > 1e-2
        np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-4)
        gj = np.asarray(gj)
        assert np.isfinite(gj).all() and np.abs(gj).max() > 0
        np.testing.assert_allclose(ls.grad.numpy(), gj, rtol=0,
                                   atol=1e-3 * np.abs(gj).max())


def quadratic_target():
    return np.array([0.3, 0.2, 0.05, 0.02])


def test_fd_history_identical_to_jax():
    target = quadratic_target()

    def obj(s):
        return float(np.sum((np.asarray(s) - target) ** 2))

    fd = dict(max_iter=15, seed=3)
    sj, hj = jst.fd_optimize(obj, [0.5, 0.5, 0.1, 0.05],
                             jst.FDConfig(**fd), log_fn=lambda m: None)
    st, ht = tst.fd_optimize(obj, [0.5, 0.5, 0.1, 0.05],
                             tst.FDConfig(**fd), log_fn=lambda m: None)
    assert len(hj) == len(ht) > 5
    for (lj, xj), (lt, xt) in zip(hj, ht):
        assert lj == lt
        np.testing.assert_array_equal(xj, xt)
    np.testing.assert_array_equal(sj, st)
    assert ht[-1][0] < 0.5 * ht[0][0]


def test_grad_optimize_matches_jax():
    target = quadratic_target()
    sj, hj = jst.grad_optimize(
        lambda s: jnp.sum((s - jnp.asarray(target, jnp.float32)) ** 2),
        [0.5, 0.5, 0.1, 0.05], steps=120, lr=0.05, log_fn=lambda m: None)
    tt = torch.tensor(target, dtype=torch.float32)
    st, ht = tst.grad_optimize(lambda s: torch.sum((s - tt) ** 2),
                               [0.5, 0.5, 0.1, 0.05], steps=120, lr=0.05,
                               log_fn=lambda m: None)
    assert len(hj) == len(ht) == 121
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ht[-1][2], hj[-1][2], rtol=0, atol=1e-5)
    assert (st > 0).all()


def test_tune_per_level_validation_gate(rng):
    """The JAX package's gate, mirrored: a tuned row that does not beat
    sigma0 on the held-out pairs is replaced by sigma0, so no row is worse
    than sigma0 there."""
    prims, rgts = toy(rng, n_pairs=8)
    cfg = SolverStaticConfig(**TOY_CFG, pallas_w_build=False)
    table = tst.tune_per_level([prims], rgts, method="grad", val_frac=0.25,
                               grad_steps=2, cfg=cfg, device="cpu")
    assert table.shape == (1, 4)
    val_obj = tst.make_objective(*tst.stack_primitives(prims[-2:], "cpu"),
                                 rgts[-2:], cfg)
    default = float(val_obj(np.asarray(SIGMA0, np.float32)))
    tuned = float(val_obj(np.asarray(table[0], np.float32)))
    assert tuned <= default + 1e-6


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """The oracle pipeline's primitive caches of 2 pairs x 2 levels, from
    both packages on the same draws, written as .npy files."""
    tmp = tmp_path_factory.mktemp("caches")
    jcfg, tcfg = configs()
    ds, dt, T_gt = pairs([3, 4])
    key = jax.random.PRNGKey(7)
    jpairs = [({k: jnp.asarray(v[b]) for k, v in ds.items()},
               {k: jnp.asarray(v[b]) for k, v in dt.items()},
               jnp.asarray(T_gt[b].astype(np.float32))) for b in range(2)]
    jpath = str(tmp / "jax.npy")
    jlev, jrgt = jst.cache_primitives(
        lambda a, b, p: jor(a, b, jcfg.layout), jpairs, JHyper(), jcfg,
        key=key, cache_path=jpath)
    # the per-pair keys cache_primitives splits off, and their draws
    subs, k = [], key
    for _ in range(2):
        k, sub = jax.random.split(k)
        subs.append(sub)
    det = [[jax_detection_mask(p[side], jcfg) for p in jpairs]
           for side in (0, 1)]
    draws = jax_pipeline_draws(jnp.stack(subs), jcfg.alter_steps,
                               np.stack(det[0]), np.stack(det[1]),
                               jcfg.keypoints)
    tpath = str(tmp / "port.npy")
    tlev, trgt = tst.cache_primitives(
        lambda a, b, p: make_oracle_completion_fn(a, b, tcfg.layout),
        [(ds, dt, T_gt)], SolverHyperParams(), tcfg, draws=[draws],
        cache_path=tpath, device="cpu")
    return (jlev, jrgt, jpath), (tlev, trgt, tpath)


def test_primitive_cache_matches_jax(caches):
    """Every keypoint row to 1e-4 but at most 1 % of them per level.  Those
    few are heatmap near ties: on these pairs one query's best source
    pixel is (337, 39) in the port and in the JAX package's eager
    `build_keypoint_sets`, but (338, 40) in its compiled pipeline, whose
    fused distance rounds otherwise (in f64 the two distances differ by
    5e-4 relative, and the port's pick is the smaller)."""
    (jlev, jrgt, _), (tlev, trgt, _) = caches
    assert len(jlev) == len(tlev) == 2
    np.testing.assert_allclose(trgt, jrgt, atol=1e-6)
    keys = ("pc", "normal", "feat", "weight")
    for lvl in range(2):
        assert len(jlev[lvl]) == len(tlev[lvl]) == 2
        rows = off = 0
        for (js, jt), (ts, tt) in zip(jlev[lvl], tlev[lvl]):
            for a, b in ((js, ts), (jt, tt)):
                assert set(a) == set(b)
                np.testing.assert_array_equal(b["valid"], a["valid"])
                assert b["valid"].any()
                assert all(b[k].dtype == np.float32 for k in keys)
                err = np.max([np.abs(b[k] - a[k]).reshape(len(a[k]), -1)
                              .max(-1) for k in keys], axis=0)
                rows += len(err)
                off += int(np.sum(err > 1e-4))
        assert off <= 0.01 * rows, (lvl, off, rows)


def _finite_table(table, levels):
    assert table.shape == (levels, 4)
    assert np.isfinite(table).all() and (table > 0).all()


def test_cache_files_read_across_packages(caches):
    """Each package's `tune_per_level` on the other's cache file, with no
    finite-difference iteration: the objective is built from the loaded
    primitives and evaluated, and sigma0 comes back."""
    (_, _, jpath), (_, _, tpath) = caches
    blob = np.load(jpath, allow_pickle=True).item()
    table = tst.tune_per_level(
        blob["primitives"], blob["R_gt"], fd=tst.FDConfig(max_iter=0),
        cfg=SolverStaticConfig(power_iters=5, pallas_w_build=False),
        device="cpu")
    _finite_table(table, 2)
    np.testing.assert_allclose(table, [SIGMA0] * 2)
    blob = np.load(tpath, allow_pickle=True).item()
    table = jst.tune_per_level(blob["primitives"][:1], blob["R_gt"],
                               fd=jst.FDConfig(max_iter=0),
                               cfg=JSolver(power_iters=5))
    _finite_table(table, 1)


@pytest.mark.parametrize("method", ["fd", "grad"])
def test_cli_on_the_cpu_from_a_cache(caches, tmp_path, method,
                                     monkeypatch):
    """The CLI reads the cache instead of running the pipeline (it pins
    the full keypoint configuration, too slow to run here) and writes a
    finite table.  To stay quick here: the first level of the port's
    cache, and 5 power iterations in the CLI's solver (30 by default)."""
    (_, _, _), (_, _, tpath) = caches
    blob = np.load(tpath, allow_pickle=True).item()
    cache = str(tmp_path / "level0.npy")
    np.save(cache, {"primitives": blob["primitives"][:1],
                    "R_gt": blob["R_gt"]}, allow_pickle=True)
    monkeypatch.setattr(tune_sigma, "SolverStaticConfig", functools.partial(
        SolverStaticConfig, power_iters=5))
    out = str(tmp_path / "sig.txt")
    table = tune_sigma.main(["--device", "cpu", "--cache", cache,
                             "--num_pairs", "2", "--rlevel", "1",
                             "--max_iter", "1", "--grad_steps", "1",
                             "--tune_method", method, "--out", out])
    _finite_table(table, 1)
    np.testing.assert_allclose(np.loadtxt(out).reshape(1, 4), table)


def test_cli_flags_match_the_jax_driver(monkeypatch):
    """The JAX driver's flags, plus --device."""
    import argparse

    from relativepose_tpu.cli import tune_sigma as jcli
    seen = []

    class Parsed(Exception):
        pass

    def grab(self, args=None, namespace=None):
        seen.append({a.dest for a in self._actions})
        raise Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    for m in (jcli, tune_sigma):
        with pytest.raises(Parsed):
            m.main([])
    assert seen[1] == seen[0] | {"device"}
