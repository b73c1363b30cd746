"""The port's evaluation CLI with every pipeline option it passes through,
against relativepose_tpu.cli.evaluate, on the CPU.

Both drivers run matterport, ours_nc, with --refit, --trans_refine, --icp
(translation-only), --step_select best_score, --per_step_errors and a
--para sigma table, on the same two synthetic pairs with oracle
completion at `--n_detect 32`.  As in tests/test_torch_cli.py the runs
draw different keypoints, so the columns that do not depend on the draws
are compared to 1e-4 (overlap, cam_dist, err_blind, err_t_id), the
per-step columns by shape, and the summaries by their keys."""

import os

import numpy as np

from relativepose_tpu.cli import evaluate as jcli
from relativepose_tpu_torch.cli import evaluate as tcli
from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_evaluate_cli_options_match_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    para = os.path.join(REPO, "relativepose_tpu_torch", "data", "params",
                        "final_param_matterport_rlevel_3.txt")
    args = ["--dataList", "synthetic", "--synthetic_family", "matterport",
            "--method", "ours_nc", "--n_detect", "32", "--maxIter", "2",
            "--batch_pairs", "2", "--rm", "--refit", "1", "--trans_refine",
            "2", "--icp", "2", "--icp_dof", "3", "--step_select",
            "best_score", "--per_step_errors", "1", "--para", para]
    rj = jcli.main(args + ["--exp", "jx"])
    rt = tcli.main(args + ["--exp", "pt", "--device", "cpu"])
    assert len(rj.error_stats) == len(rt.error_stats) == 2
    for a, b in zip(rj.error_stats, rt.error_stats):
        assert set(a) == set(b)
        for k in ("overlap", "cam_dist", "err_blind", "err_t_id"):
            np.testing.assert_allclose(float(a[k]), float(b[k]), atol=1e-4,
                                       err_msg=k)
        assert np.shape(b["rot_steps"]) == np.shape(a["rot_steps"]) == (3,)
        assert np.isfinite(b["rot_steps"]).all()
        assert np.isfinite(b["T_hat"]).all()
    sj, st = rj.summary(), rt.summary()
    assert set(sj) == set(st)
    assert any(k.startswith("rot_steps_") for k in st)
