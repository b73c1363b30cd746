"""The helpers of `relativepose_tpu_torch/train/mesh.py` against the JAX
package's `train/mesh.py` (its virtual 8-device CPU mesh)."""

import jax
import numpy as np
import pytest
import torch

from relativepose_tpu.train import mesh as jmesh
from relativepose_tpu_torch.models import convert
from relativepose_tpu_torch.models.resnet import Resnet18_8s
from relativepose_tpu_torch.models.scnet import SCNet
from relativepose_tpu_torch.train import mesh, mesh_dryrun


def _jax_sharded(tree, model_parallel):
    m = jmesh.make_mesh(8, model_parallel=model_parallel,
                        devices=jax.devices()[:8])
    specs = jmesh.param_sharding(tree, m)
    flat = convert.flatten_params(jax.tree.map(
        lambda s: np.asarray("model" in tuple(s.spec)), specs))
    return {k for k, v in flat.items() if bool(v)}


@pytest.mark.parametrize("net, mp", [
    (lambda: SCNet(ngf=16), 2),
    (lambda: SCNet(ngf=16, internal_size=(64, 128)), 2),
    (lambda: Resnet18_8s(base_width=64), 2),
    (lambda: Resnet18_8s(base_width=64), 4),
])
def test_param_sharding_matches_jax_rule(net, mp):
    """The kernels split over the model axis are the ones the JAX rule
    splits on the same tree (named through models/convert.py), and there
    are some."""
    model = net()
    names = mesh.param_sharding(model, mesh.Mesh(data=8 // mp, model=mp))
    ours = {convert._rename(n, convert._rules(model), 0, 1, ".", "/")[0]
            for n in names}
    assert ours and ours == _jax_sharded(convert.flax_params(model), mp)


def test_pad_and_shard_an_uneven_tail():
    """3 pairs over 2 data ranks: zero rows pad the tail as the JAX
    package's pad_batch_to does, then each rank takes its half; 0-d
    leaves pass through."""
    x = np.arange(3 * 2 * 5, dtype=np.float32).reshape(3, 2, 5)
    batch = {"x": torch.from_numpy(x), "n": torch.tensor(3.0),
             "y": x[:, 0]}
    ref = jmesh.pad_batch_to({"x": x, "y": x[:, 0]}, 2)
    padded = mesh.pad_batch_to(batch, 2)
    np.testing.assert_array_equal(padded["x"].numpy(), ref["x"])
    np.testing.assert_array_equal(padded["y"], ref["y"])
    assert float(padded["n"]) == 3.0
    halves = [mesh.shard_batch(padded, mesh.Mesh(data=2, data_index=i))
              for i in (0, 1)]
    np.testing.assert_array_equal(
        torch.cat([h["x"] for h in halves]).numpy(), ref["x"])
    assert halves[1]["x"].shape == (2, 2, 5)
    np.testing.assert_array_equal(halves[1]["x"][1].numpy(), 0.0)
    with pytest.raises(ValueError, match="pad_batch_to"):
        mesh.shard_batch(batch, mesh.Mesh(data=2))


def test_one_rank_mesh_is_the_identity():
    m = mesh.make_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.is_main
    x = torch.arange(6.0)
    assert mesh.shard_batch(x, m) is not None
    np.testing.assert_array_equal(mesh.shard_batch(x, m).numpy(), x.numpy())
    assert mesh.global_sum(x) is x and mesh.group_size() == 1
    assert mesh.all_agree(True, "cpu") and not mesh.all_agree(False, "cpu")
    with pytest.raises(RuntimeError, match="init_distributed"):
        mesh.make_mesh(2)


def test_one_rank_group_is_the_plain_step(tmp_path):
    """The step on a 1-rank gloo group (the mesh's path: statistics and
    loss sums through the group, DDP) against the step without one, in
    f32, SCNet at ngf 8 (`tests/test_torch_mesh.py` holds N ranks to the
    1-rank group).
    The two divide the same sums once, a mean against a sum over a count:
    the loss to 1e-6 relative, the parameters within 1e-6 for 99.9 % of
    them and within 2 lr for all (Adam's first step moves a parameter by
    lr * sign(gradient), which flips where a gradient is near 0), the
    bound `tests/test_torch_gpu.py` holds the card's training steps to."""
    ref = mesh_dryrun.step(ngf=8, eval_pairs=False)
    got = mesh_dryrun.one_rank_step(str(tmp_path), ngf=8, eval_pairs=False)
    assert abs(got[0]["loss"] - ref[0]["loss"]) <= 1e-6 * ref[0]["loss"]
    diff = np.concatenate([np.abs(got[1][k] - ref[1][k]).ravel()
                           for k in ref[1]])
    assert np.mean(diff <= 1e-6) >= 0.999
    assert diff.max() <= 2 * 2e-4
