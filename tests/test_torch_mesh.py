"""`relativepose_tpu_torch/train/mesh.py` on the CPU: spawned gloo ranks
against the step on one rank.

The step is `train/mesh_dryrun.py` at the JAX dry run's size
(`__graft_entry__.py`: SCNet ngf 16, feature net width 8, 2 synthetic
suncg pairs, one completion step, then the sharded evaluation of the 2
pairs).  The mesh runs are held to the same step in this process on a
1-rank gloo group, with SCNet and the feature net computing in f64
(parameters and Adam in f32; a process group's BatchNorm keeps f64
statistics for f64 activations).  There every parameter after the step
must be within 1e-5 of the 1-rank step, and so must the loss: this is
what shows that the batch statistics and the draws are the global
batch's.  f64 because in f32 the mesh and one rank round their batch
sums in another order, SCNet's 1x1 bottleneck, whose BatchNorm
normalises 8 values per channel, amplifies that to about 3e-5 of the
gradient norm, and Adam's first step, g / (|g| + eps), then moves a few
hundred of the 3 million near-zero entries by up to 2 lr.  The 1-rank
group against the step without a group is in
`tests/test_torch_mesh_rules.py`.
"""

import numpy as np
import pytest
import torch

from relativepose_tpu_torch.train import mesh_dryrun

F64 = dict(dtype=torch.float64)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return mesh_dryrun.one_rank_step(str(tmp_path_factory.mktemp("g")),
                                     **F64)


def _assert_same_step(got, ref):
    assert abs(got[0]["loss"] - ref[0]["loss"]) < 1e-5
    assert got[1].keys() == ref[1].keys()
    for k in ref[1]:
        np.testing.assert_allclose(got[1][k], ref[1][k], atol=1e-5,
                                   err_msg=k)


def test_data_parallel_step_and_sharded_eval(one_rank):
    """2 data ranks: the step, and the poses of the sharded evaluation
    (one pair per rank) gathered back."""
    got = mesh_dryrun.dryrun(2, 1, **F64)
    _assert_same_step(got, one_rank)
    assert got[3] == []
    assert got[2].shape == (2, 4, 4) and np.isfinite(got[2]).all()
    np.testing.assert_allclose(got[2], one_rank[2], atol=1e-5)


def test_data_x_model_step(one_rank):
    """2 x 2: data parallel over 2 ranks, the bottleneck kernel split over
    the model axis of 2 (the sharded evaluation is the 2-rank test's)."""
    got = mesh_dryrun.dryrun(4, 2, eval_pairs=False, **F64)
    _assert_same_step(got, one_rank)
    assert got[3] == ["convs.14.conv.weight"]
