"""Overlap statistics and the evaluation harness of relativepose_tpu_torch
against relativepose_tpu, on the CPU.

Tolerances: bucket names, counts, repeat indices and which batches run
must be equal; overlap ratios are counts over counts and are held to
1e-6; distances and pose errors (f32 sums in another order) to 1e-5
absolute, or 1e-4 degrees for geodesic angles near 0 (arccos is steep
there); lifted point clouds to 1e-6 relative.  The stream tests mirror
tests/test_eval_and_utils.py:17-200 with stub eval fns."""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from relativepose_tpu.core import overlap as joverlap
from relativepose_tpu.eval import harness as jh
from relativepose_tpu_torch.core import overlap as toverlap
from relativepose_tpu_torch.data import datasets as tdsets
from relativepose_tpu_torch.eval import harness as th
from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(x):
    return torch.from_numpy(np.array(x))


def rigid(rng):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = ScipyRot.random(random_state=rng).as_matrix()
    T[:3, 3] = rng.randn(3)
    return T


def overlap_cases(rng):
    """Full, zero and partial overlap with masks (the JAX package's
    TestOverlap cases), as one batch of three pairs."""
    n = 400
    a = rng.randn(n, 3).astype(np.float32)
    T = rigid(rng)
    full = (a, a @ T[:3, :3].T + T[:3, 3], T)
    zero = (a, rng.randn(n, 3).astype(np.float32) + 100.0, np.eye(4))
    part = (a, np.concatenate([a[:200], a[:200] + 50.0]), np.eye(4))
    src, tgt, Ts = (np.stack(x).astype(np.float32)
                    for x in zip(full, zero, part))
    sv = np.ones((3, n), bool)
    tv = np.ones((3, n), bool)
    sv[2, 350:] = False   # invalid points count nowhere
    tv[1, :10] = False
    return src, sv, tgt, tv, Ts


def test_point_cloud_overlap_matches_jax(rng):
    src, sv, tgt, tv, Ts = overlap_cases(rng)
    out = toverlap.point_cloud_overlap(t(src), t(sv), t(tgt), t(tv), t(Ts))
    for b in range(3):
        oj = joverlap.point_cloud_overlap(
            jnp.asarray(src[b]), jnp.asarray(sv[b]), jnp.asarray(tgt[b]),
            jnp.asarray(tv[b]), jnp.asarray(Ts[b]))
        for k in oj:
            np.testing.assert_allclose(float(oj[k]), float(out[k][b]),
                                       rtol=1e-6, atol=1e-5, err_msg=k)
    assert float(out["overlap"][0]) == pytest.approx(1.0)
    assert float(out["pc_nn"][0]) == pytest.approx(0.0, abs=1e-3)
    assert float(out["cam_dist"][0]) == pytest.approx(
        np.linalg.norm(Ts[0, :3, 3]), rel=1e-5)
    assert float(out["overlap"][1]) == 0.0
    assert 0.4 < float(out["overlap"][2]) < 0.6


@pytest.mark.parametrize("chunk", [7, 2048])
def test_nn_sq_dists_chunks(rng, chunk):
    """The same distances whatever the chunk, equal to the JAX package's;
    invalid queries get 1e30 and invalid refs are never nearest."""
    q = rng.randn(2, 50, 3).astype(np.float32)
    r = rng.randn(2, 60, 3).astype(np.float32)
    qv, rv = rng.rand(2, 50) > 0.2, rng.rand(2, 60) > 0.3
    d = toverlap.nn_sq_dists(t(q), t(qv), t(r), t(rv), chunk=chunk).numpy()
    for b in range(2):
        dj = np.asarray(joverlap.nn_sq_dists(
            jnp.asarray(q[b]), jnp.asarray(qv[b]), jnp.asarray(r[b]),
            jnp.asarray(rv[b])))
        np.testing.assert_allclose(dj, d[b], rtol=1e-5, atol=1e-5)
        exact = ((q[b][:, None] - r[b][rv[b]][None]) ** 2).sum(-1).min(1)
        np.testing.assert_allclose(d[b][qv[b]], exact[qv[b]], atol=1e-5)
    assert (d[~qv] == 1e30).all()


def test_bucket_of():
    for v in (0.0, 0.05, 0.1, 0.1000001, 0.3, 0.5, 0.51, 0.9, 1.0):
        assert th.bucket_of(v) == jh.bucket_of(v)
    assert th.OVERLAP_BUCKETS == jh.OVERLAP_BUCKETS
    assert th.CLASSICAL_METHODS == jh.CLASSICAL_METHODS


def test_pose_errors_match_jax(rng):
    T_hat = np.stack([rigid(rng), np.eye(4, dtype=np.float32), rigid(rng)])
    T_gt = np.stack([rigid(rng), np.eye(4, dtype=np.float32), T_hat[2]])
    pc = rng.randn(3, 50, 3).astype(np.float32)
    valid = rng.rand(3, 50) > 0.2
    out = th.pose_errors(t(T_hat), t(T_gt), t(pc), t(valid))
    for b in range(3):
        ej = jh.pose_errors(jnp.asarray(T_hat[b]), jnp.asarray(T_gt[b]),
                            jnp.asarray(pc[b]), jnp.asarray(valid[b]))
        assert set(ej) == set(out)
        for k in ej:
            atol = 1e-4 if k in ("err_ad", "err_blind") else 1e-5
            np.testing.assert_allclose(float(ej[k]), float(out[k][b]),
                                       atol=atol, err_msg=k)
    # the err_t formula, ||(R_hat - R_gt) @ mean(pc) + t_hat - t_gt||
    m = pc[0][valid[0]].mean(0)
    expect = np.linalg.norm((T_hat[0, :3, :3] - T_gt[0, :3, :3]) @ m
                            + T_hat[0, :3, 3] - T_gt[0, :3, 3])
    assert float(out["err_t"][0]) == pytest.approx(expect, rel=1e-4)
    assert float(out["err_ad"][1]) < 1e-3 and float(out["err_t"][1]) < 1e-6


@pytest.mark.parametrize("dataset, method, full", [
    ("suncg", "ours", False), ("matterport", "ours_nr", False),
    ("scannet", "ours", True), ("scannet", "gs", True),
    ("scannet", "gs", False)])
def test_parse_eval_data(rng, dataset, method, full):
    """The observed region of each dataset: the second face, the kinect
    crop for scannet 'ours' (or without the full frame), and the 480x640
    frame for scannet with a classical method."""
    depth = (rng.rand(2, 160, 640) + 0.5).astype(np.float32)
    depth[:, ::9] = 0.0
    rgb = rng.rand(2, 160, 640, 3).astype(np.float32)
    norm = rng.rand(2, 160, 640, 3).astype(np.float32)
    kw_np, kw_t = {}, {}
    if full:
        df = (rng.rand(2, 480, 640) + 0.5).astype(np.float32)
        rf = rng.rand(2, 480, 640, 3).astype(np.float32)
        kw_np = dict(depth_full=df, rgb_full=rf)
        kw_t = dict(depth_full=t(df), rgb_full=t(rf))
    pc, valid, col = th.parse_eval_data(t(depth), t(rgb), t(norm), dataset,
                                        method, **kw_t)
    for b in range(2):
        out_j = jh.parse_eval_data(
            jnp.asarray(depth[b]), jnp.asarray(rgb[b]), jnp.asarray(norm[b]),
            dataset, method,
            **{k: jnp.asarray(v[b]) for k, v in kw_np.items()})
        np.testing.assert_allclose(np.asarray(out_j[0]), pc[b].numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(np.asarray(out_j[1]), valid[b].numpy())
        np.testing.assert_array_equal(np.asarray(out_j[2]), col[b].numpy())
    n = {"suncg": 160 * 160, "matterport": 160 * 160}.get(
        dataset, 480 * 640 if (full and method == "gs") else 66 * 88)
    assert pc.shape == (2, n, 3) and col.shape == (2, n, 3)


def test_sigma_tables_are_copies():
    """The port's sigma tables are byte-equal to the JAX package's, and
    both packages read the same [3, 4] tables and per-step sigmas."""
    for ds in ("suncg", "matterport", "scannet"):
        name = f"final_param_{ds}_rlevel_3.txt"
        assert filecmp.cmp(
            os.path.join(REPO, "relativepose_tpu_torch", "data", "params",
                         name),
            os.path.join(REPO, "relativepose_tpu", "data", "params", name),
            shallow=False)
        table = th.default_sigma_table(ds)
        np.testing.assert_array_equal(table, jh.default_sigma_table(ds))
        assert table.shape == (3, 4) and (table > 0).all()
        hj = jh.hyper_params_from_table(table, alter_steps=3)
        ht = th.hyper_params_from_table(table, alter_steps=3)
        for f in ("sigma_angle1", "sigma_angle2", "sigma_dist",
                  "sigma_feat"):
            np.testing.assert_array_equal(np.asarray(getattr(hj, f)),
                                          getattr(ht, f).numpy())
    np.testing.assert_allclose(
        th.default_sigma_table("suncg")[0],
        [1.2974606, 0.31758944, 0.03550027, 0.00872483], rtol=1e-5)
    with pytest.raises(ValueError):
        th.hyper_params_from_table(table[:2], alter_steps=3)
    assert th.hyper_params_from_table(None).sigma_dist == 0.04


def test_eval_config_matches_jax():
    for method in ("ours", "ours_nr", "ours_nc"):
        for override in (None, 2):
            a = jh.EvalConfig(method=method, alter_steps_override=override)
            b = th.EvalConfig(method=method, alter_steps_override=override)
            assert (a.alter_steps, a.completion) == (b.alter_steps,
                                                     b.completion)


def test_runner_resume_by_count(tmp_path):
    results = [{"overlap": o, "err_ad": 1.0 + i, "err_t": 0.1 * i,
                "err_blind": 3.0, "err_t_blind": 0.2, "err_t_id": 0.3}
               for i, o in enumerate((0.05, 0.3, 0.3, 0.9))]
    summaries = []
    for mod, sub in ((jh, "j"), (th, "t")):
        cfg = mod.EvalConfig(exp="r", out_dir=str(tmp_path / sub),
                             save_every=2)
        r = mod.EvalRunner(cfg)
        for res in results:
            r.record(dict(res))
        r.save()
        r2 = mod.EvalRunner(cfg)
        assert r2.n_done == 4 and len(r2.ad_stats["0.1-0.5"]) == 2
        summaries.append(r2.summary())
    assert summaries[0] == summaries[1]


def _stub_eval(calls, seeds):
    def eval_fn(data_s, data_t, T_gt, seed):
        calls.append(int(T_gt.shape[0]))
        seeds.append(seed)
        n = T_gt.shape[0]
        return {"overlap": np.full((n,), 0.3), "err_ad": np.full((n,), 1.0),
                "err_t": np.full((n,), 0.1)}
    return eval_fn


def _batches(n_pairs, batch):
    out = []
    for s in range(0, n_pairs, batch):
        n = min(batch, n_pairs - s)
        out.append(({"i": np.arange(s, s + n)}, {"i": np.arange(s, s + n)},
                    np.tile(np.eye(4), (n, 1, 1))))
    return out


def test_evaluate_stream_repeats_and_resume(tmp_path):
    """num_repeat passes append to one result file; a finished run
    resumed evaluates nothing; a run killed after 3 of 12 results re-runs
    only the partial batch and the rest, with the draw seeds the first run
    used for those batches."""
    calls, seeds = [], []
    cfg = th.EvalConfig(exp="rep", out_dir=str(tmp_path), num_repeat=2)
    runner = th.evaluate_stream(lambda: _batches(6, 2),
                                _stub_eval(calls, seeds), cfg, seed=4)
    assert len(runner.error_stats) == 12
    assert [r["repeat"] for r in runner.error_stats] == [0] * 6 + [1] * 6
    assert len(calls) == 6 and len(set(seeds)) == 6
    assert seeds[3] == th.batch_seed(4, 1, 0)
    calls2 = []
    r2 = th.evaluate_stream(lambda: _batches(6, 2), _stub_eval(calls2, []),
                            cfg, seed=4)
    assert len(r2.error_stats) == 12 and calls2 == []

    cfg3 = th.EvalConfig(exp="res", out_dir=str(tmp_path), num_repeat=2)
    pre = th.EvalRunner(cfg3)
    for _ in range(3):
        pre.record({"overlap": 0.3, "err_ad": 1.0, "err_t": 0.1,
                    "repeat": 0})
    pre.save()
    calls3, seeds3 = [], []
    r3 = th.evaluate_stream(lambda: _batches(6, 2),
                            _stub_eval(calls3, seeds3), cfg3, seed=4)
    assert len(r3.error_stats) == 12 and len(calls3) == 5
    assert seeds3 == seeds[1:]


def test_evaluate_stream_max_iter_and_padded_tail(tmp_path):
    """--maxIter 6 at batch 4 over 10 pairs evaluates exactly 6 pairs
    (2 calls), the first call's time is compile_s and left out of
    sec_per_pair; a padded tail records only its real rows.  The JAX
    harness, fed the same batches, records the same rows."""
    def batches(sizes):
        return [({"i": np.arange(4)}, {"i": np.arange(4)},
                 np.tile(np.eye(4), (4, 1, 1)), n) for n in sizes]

    counts = []
    for mod in (jh, th):
        calls = []
        cfg = mod.EvalConfig(exp="cap", out_dir=str(tmp_path / mod.__name__),
                             max_iter=6)
        runner = mod.evaluate_stream(lambda: batches((4, 4, 2)),
                                     _stub_eval(calls, []), cfg)
        assert runner.compile_s is not None and len(runner.speed) == 2
        cfg2 = mod.EvalConfig(exp="tail",
                              out_dir=str(tmp_path / mod.__name__))
        r2 = mod.evaluate_stream(lambda: batches((4, 1)),
                                 _stub_eval([], []), cfg2)
        counts.append((len(runner.error_stats), len(calls),
                       len(r2.error_stats)))
    assert counts[0] == counts[1] == (6, 2, 5)


def test_batched_pads_the_tail():
    """datasets.batched: numpy batches, the tail padded by repeating the
    last item, n_valid the real rows."""
    class Source:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            d = {"rgb": np.full((2, 2, 3), i, np.float32),
                 "norm": np.zeros((2, 2, 3)), "depth": np.zeros((2, 2)),
                 "segm": np.zeros((2, 2), np.int32)}
            return {"data_s": d, "data_t": d, "T_gt": np.eye(4) * i}

    out = list(tdsets.batched(Source(), 2, max_items=5))
    assert [b[3] for b in out] == [2, 2, 1]
    ds, _, T, n = out[-1]
    assert isinstance(ds["rgb"], np.ndarray) and ds["rgb"].shape[0] == 2
    assert (ds["rgb"][1] == 4).all() and T[1, 0, 0] == 4
