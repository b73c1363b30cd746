"""Pipeline options of relativepose_tpu_torch against relativepose_tpu:
matterport and ScanNet with oracle completion, and the ICP polish
(step_select='best_score' is in tests/test_torch_pipeline.py, beside
the other test that runs the JAX pipeline unrolled).

The small configuration of `__graft_entry__.py` (n_detect=32, n_match=16,
n_random=8, power_iters=5) with alter_steps=2, ground-truth (oracle)
completion, two pairs per test.  The port gets the JAX package's random
draws, so every step's pose must agree to 1e-4, as in
tests/test_torch_pipeline.py."""

import numpy as np
import pytest
import torch

from relativepose_tpu_torch.match.solver import SolverHyperParams
from relativepose_tpu_torch.pipeline import recurrent as trec
from relativepose_tpu_torch.pipeline.oracle import make_oracle_completion_fn
from torch_parity import configs, pairs, run_oracle_both
from torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("dataset, seeds", [("matterport", [29, 30]),
                                            ("scannet", [15, 16])])
def test_oracle_pipeline_matches_jax_on_other_datasets(dataset, seeds):
    """Matterport (the 'second' mask, matterport's face order) and ScanNet
    (the kinect window, DoG on the 480x640 frames) with oracle completion,
    two pairs, every step's pose to 1e-4 on the JAX package's draws."""
    ds, dt, _ = pairs(seeds, dataset)
    mask = "kinect" if dataset == "scannet" else "second"
    jcfg, tcfg = configs(dataset=dataset, mask_method=mask)
    steps_j, T, steps_t, _ = run_oracle_both(ds, dt, 5, jcfg, tcfg)
    np.testing.assert_allclose(steps_j, steps_t.numpy(), atol=1e-4)
    np.testing.assert_array_equal(T.numpy(), steps_t.numpy()[:, -1])
    assert np.isfinite(T.numpy()).all()
    assert not np.allclose(T.numpy(), np.eye(4))


@pytest.mark.parametrize("dof", [6, 3])
def test_icp_pipeline_matches_jax(dof):
    """icp_iters=3 polishes every step's pose (not an identity) in both
    packages alike (1e-4).  The step scores stay the solver's scores of
    the poses before the polish, as in the JAX package."""
    ds, dt, _ = pairs([31, 32])
    jcfg, tcfg = configs(icp_iters=3, icp_dof=dof)
    steps_j, _, steps_t, draws = run_oracle_both(ds, dt, 6, jcfg, tcfg)
    np.testing.assert_allclose(steps_j, steps_t.numpy(), atol=1e-4)
    _, plain = configs()
    dev_s, dev_t = trec.as_pair_batch(ds, "cpu"), trec.as_pair_batch(dt, "cpu")
    T0 = trec.estimate_pose_via_completion(
        make_oracle_completion_fn(dev_s, dev_t, plain.layout), ds, dt,
        SolverHyperParams(), trec.PipelineConfig(
            alter_steps=1, keypoints=plain.keypoints, solver=plain.solver),
        draws=draws[:1], device="cpu")
    assert not torch.allclose(T0, steps_t[:, 0])
    if dof == 3:
        torch.testing.assert_close(T0[:, :3, :3], steps_t[:, 0, :3, :3],
                                   rtol=0, atol=0)
