"""The classical baselines of both packages' evaluation CLIs, on the CPU.

`--method gs` and `--method fgs` run through `relativepose_tpu.cli.
evaluate` and `relativepose_tpu_torch.cli.evaluate --device cpu` on the
same 4 synthetic suncg pairs, each in its own directory (so neither reads
the other's overlap cache); the port's run resumes once on the way.  Both must skip the same low-overlap pairs
and record the same `pair_idx`s, with overlap statistics within 1e-6 and
pose errors within 1e-4: the two native builds agree bit for bit
(`tests/test_torch_native.py`), and what is left is the f32 bookkeeping
of the two frameworks."""

import os

import numpy as np
import pytest

from relativepose_tpu.cli import evaluate as jcli
from relativepose_tpu_torch.cli import evaluate as tcli
from torch_parity import one_torch_thread  # noqa: F401

OVERLAP = ("overlap", "cam_dist", "pc_dist", "pc_nn")
ERRORS = ("err_ad", "err_blind", "err_t", "err_t_blind", "err_t_id")


def _run(cli, where, monkeypatch, method, *extra):
    os.makedirs(where, exist_ok=True)
    monkeypatch.chdir(where)
    return cli.main(["--dataList", "synthetic", "--synthetic_family",
                     "suncg", "--method", method, "--maxIter", "4", "--rm",
                     "--exp", "cl", *extra])


@pytest.mark.parametrize("method", ["gs", "fgs"])
def test_classical_cli_matches_jax(tmp_path, monkeypatch, method):
    """The port's run is made in two parts, 1 pair and then 4 pairs
    without --rm: the second resumes after the highest recorded pair
    index (skipped pairs leave no row) and reads the overlap cache."""
    rj = _run(jcli, tmp_path / "jax", monkeypatch, method)
    first = _run(tcli, tmp_path / "port", monkeypatch, method,
                 "--device", "cpu", "--maxIter", "1")
    assert [int(r["pair_idx"]) for r in first.error_stats] == [0]
    rt = tcli.main(["--dataList", "synthetic", "--synthetic_family",
                    "suncg", "--method", method, "--maxIter", "4", "--exp",
                    "cl", "--device", "cpu"])
    assert [int(r["pair_idx"]) for r in rt.error_stats] == \
        [int(r["pair_idx"]) for r in rj.error_stats]
    assert len(rt.error_stats) >= 2
    for a, b in zip(rj.error_stats, rt.error_stats):
        assert set(a) == set(b)
        for k in OVERLAP:
            np.testing.assert_allclose(float(b[k]), float(a[k]), atol=1e-6,
                                       err_msg=k)
        assert float(b["overlap"]) >= 0.1
        for k in ERRORS:
            np.testing.assert_allclose(float(b[k]), float(a[k]), atol=1e-4,
                                       err_msg=k)
        np.testing.assert_array_equal(b["T_hat"], a["T_hat"])
    assert set(rt.summary()) == set(rj.summary())
    # the overlap cache and the result file, where the JAX package keeps
    # them
    assert len(os.listdir(tmp_path / "port/tmp/overlap_cache")) == 4
    assert os.path.exists(tmp_path / "port/tmp/rpe/cl/cl.result.npy")
