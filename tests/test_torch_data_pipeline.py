"""The port's training data pipeline against relativepose_tpu.data, on
the CPU.

Synthetic pairs from the port's own scene generator go through the JAX
package's compiled (jit over vmap, as `gather_batch` runs it) functions
and the port's batched ones, with the JAX package's draws handed to the
port (`tests/torch_parity.py::jax_pair_draws`).  Tolerances:
  * dense correspondences: idx_src, idx_tgt and valid exactly equal;
  * the decoded batch (encode -> resident store -> gather -> decode):
    exactly equal;
  * the perturbed reprojection: which pixels the splat fills (the mask
    channel) and the envelope box exactly equal; the splatted values and
    the residual pose dr within 1e-6 (rotated normals and depths of order
    1, rounded in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.data import device_store as jstore
from relativepose_tpu.data import pipeline as jpipe
from relativepose_tpu_torch.data import datasets as dsets
from relativepose_tpu_torch.data import device_store as tstore
from relativepose_tpu_torch.data import pipeline as tpipe
from torch_parity import (
    jax_corres_draws,
    jax_pair_draws,
    synthetic_pair_arrays,
)
from torch_parity import one_torch_thread  # noqa: F401

VALUE_TOL = 1e-6


def f32(a):
    return {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
            for k, v in a.items()}


def jax_batch(a, keys, dataset):
    fn = jax.jit(jax.vmap(lambda r, n, d, p, s, k: jpipe.assemble_pair_batch(
        r, n, d, p, s, k, dataset)))
    out = fn(*(jnp.asarray(a[k]) for k in ("rgb", "norm", "depth", "pose")),
             jnp.asarray(a["segm"].astype(np.int32)), keys)
    return jax.tree.map(np.asarray, out)


def torch_batch(a, draws, dataset):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return tpipe.assemble_pair_batch(t["rgb"], t["norm"], t["depth"],
                                     t["pose"], t["segm"].long(), draws,
                                     dataset)


@pytest.mark.parametrize("dataset", ["suncg", "scannet"])
def test_assemble_pair_batch_matches_jax(dataset):
    a = f32(synthetic_pair_arrays([0, 1], dataset))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    oj = jax_batch(a, keys, dataset)
    ot = torch_batch(a, jax_pair_draws(keys, a["depth"][:, 0], dataset),
                     dataset)
    for k in ("idx_src", "idx_tgt", "valid"):
        np.testing.assert_array_equal(ot["denseCorres"][k].numpy(),
                                      oj["denseCorres"][k], err_msg=k)
    assert oj["denseCorres"]["valid"].all()
    np.testing.assert_array_equal(ot["proj_view8"][..., 7].numpy(),
                                  oj["proj_view8"][..., 7])
    np.testing.assert_array_equal(ot["proj_box"].numpy(), oj["proj_box"])
    np.testing.assert_allclose(ot["proj_view8"].numpy(), oj["proj_view8"],
                               atol=VALUE_TOL)
    np.testing.assert_allclose(ot["proj_dr"].numpy(), oj["proj_dr"],
                               atol=VALUE_TOL)
    np.testing.assert_array_equal(ot["dataMask"].numpy(), oj["dataMask"])


@pytest.mark.parametrize("dataset", ["suncg", "matterport", "scannet"])
def test_dense_correspondences_match_jax(dataset):
    """The matterport row (masked queries, 2000 correspondences) too, and
    a pair with no overlap: valid 0 in both."""
    a = f32(synthetic_pair_arrays([2, 3], dataset))
    # pair 1: the target view moved 100 m away, so nothing matches
    a["pose"][1, 1, :3, 3] += 100.0
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    dc = jax.jit(jax.vmap(lambda ds, dt, ps, pt, k: jpipe.dense_correspondences(
        ds, dt, ps, pt, k, dataset)))
    oj = jax.tree.map(np.asarray, dc(
        jnp.asarray(a["depth"][:, 0]), jnp.asarray(a["depth"][:, 1]),
        jnp.asarray(a["pose"][:, 0]), jnp.asarray(a["pose"][:, 1]), keys))
    q_idx, pick_u = jax_corres_draws(keys, a["depth"][:, 0], dataset)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    ot = tpipe.dense_correspondences(t["depth"][:, 0], t["depth"][:, 1],
                                     t["pose"][:, 0], t["pose"][:, 1],
                                     q_idx, pick_u, dataset)
    np.testing.assert_array_equal(ot["valid"].numpy(), oj["valid"])
    assert oj["valid"].tolist() == [1, 0]
    # the indices of a pair without correspondences are unused
    for k in ("idx_src", "idx_tgt"):
        np.testing.assert_array_equal(ot[k][0].numpy(), oj[k][0], err_msg=k)


@pytest.mark.parametrize("n", [1, 7, 16, 17, 256, 5000, 5001])
def test_xla_cumsum_matches_jnp_cumsum(n):
    x = np.random.RandomState(n).rand(3, n).astype(np.float32)
    np.testing.assert_array_equal(
        tpipe._xla_cumsum(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1)))


def test_store_encode_gather_decode_matches_jax():
    """The resident store of both packages from one source, one gather:
    the decoded rgb / norm / depth / segm / pose exactly equal, and the
    whole assembled batch as in `test_assemble_pair_batch_matches_jax`."""
    src = dsets.SyntheticPairs("suncg", n=4, seed=5, full_frames=False)
    js = jstore.DeviceStore(src, with_full_frames=False)
    ts = tstore.DeviceStore(src, device="cpu", with_full_frames=False)
    fields = ("rgb", "norm", "depth", "segm")
    decoded = tstore.decode_batch(*(ts.arrays[f] for f in fields))
    for k, v in zip(fields, decoded):
        np.testing.assert_array_equal(
            v.numpy(), _decoded(np.asarray(js.arrays[k]), k), err_msg=k)
    np.testing.assert_array_equal(ts.arrays["pose"].numpy(),
                                  np.asarray(js.arrays["pose"]))
    idx = np.array([3, 1], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(2), 2)
    oj = jax.tree.map(np.asarray, jstore.gather_batch(
        js.arrays, jnp.asarray(idx), keys, "suncg"))
    draws = jax_pair_draws(keys, oj["depth"][:, 0], "suncg")
    ot = tstore.gather_batch(ts.arrays, torch.from_numpy(idx).long(),
                             "suncg", draws=draws)
    for k in ("rgb", "norm", "depth", "segm", "pose", "dataMask"):
        np.testing.assert_array_equal(ot[k].numpy(), oj[k], err_msg=k)
    for k in ("idx_src", "idx_tgt", "valid"):
        np.testing.assert_array_equal(ot["denseCorres"][k].numpy(),
                                      oj["denseCorres"][k], err_msg=k)
    np.testing.assert_allclose(ot["proj_view8"].numpy(), oj["proj_view8"],
                               atol=VALUE_TOL)


def _decoded(v, k):
    """The JAX package's compiled decode of one encoded array."""
    scale = {"rgb": 255.0, "norm": 127.0, "depth": 1000.0}.get(k)
    if scale is None:
        return v.astype(np.int64) if k == "segm" else v
    return np.asarray(jax.jit(lambda a: a.astype(jnp.float32) / scale)(v))


def test_reproj_box_is_half_open():
    """A warp that lands nowhere gives the box [0, H-1) x [0, W-1), as
    in the JAX package; otherwise the box is [r0, r1) x [c0, c1) of the
    splat's first and last rows and columns."""
    view = torch.zeros(2, 160, 640, 8)
    view[1, :, 160:320, 6] = 2.0
    view[1, :, 160:320, 7] = 1.0
    pose = torch.eye(4).expand(2, 4, 4).clone()
    out = tpipe.reproj_augment(view, pose, pose, torch.full((2, 3), 0.7),
                               torch.full((2,), 0.3), torch.zeros(2, 3),
                               "suncg")
    empty = out["box"][0]
    assert empty[:-1, :-1].all()
    assert empty[-1].sum() == 0 and empty[:, -1].sum() == 0
    hit = out["view8"][1, ..., 6] != 0
    rows = torch.nonzero(hit.any(-1))[:, 0]
    cols = torch.nonzero(hit.any(-2))[:, 0]
    box = out["box"][1]
    assert box[rows.min(), cols.min()] == 1
    assert box[rows.max(), :].sum() == 0 and box[:, cols.max()].sum() == 0
