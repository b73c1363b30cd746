"""Geometry of relativepose_tpu_torch against relativepose_tpu, on the CPU.

Inputs come from numpy seeds and go to both packages.  Tolerances: results
built only from exact operations (signed-permutation rotations, masks, the
splat's winners) must be equal; f32 results whose sums the two frameworks
order differently are held to 1e-5 (absolute, on values of order 1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.core import horn as jhorn
from relativepose_tpu.core import masking as jmask
from relativepose_tpu.core import quaternion as jquat
from relativepose_tpu.core import rotation as jrot
from relativepose_tpu.core import skybox as jsky
from relativepose_tpu.core import warp as jwarp
from relativepose_tpu.data import synthetic as jsyn
from relativepose_tpu.ops import eig4x4 as jeig
from relativepose_tpu.pipeline.recurrent import make_view as jmake_view
from relativepose_tpu_torch.core import horn as thorn
from relativepose_tpu_torch.core import masking as tmask
from relativepose_tpu_torch.core import quaternion as tquat
from relativepose_tpu_torch.core import rotation as trot
from relativepose_tpu_torch.core import skybox as tsky
from relativepose_tpu_torch.core import warp as twarp
from relativepose_tpu_torch.data import synthetic as tsyn
from relativepose_tpu_torch.ops import eig4x4 as teig
from relativepose_tpu_torch.pipeline.recurrent import make_view as tmake_view
from torch_parity import one_torch_thread  # noqa: F401

TOL = 1e-5  # f32 sums in another order, values of order 1


def t(x):
    return torch.from_numpy(np.array(x))


def random_rotations(rng, n):
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = rng.uniform(0.2, 3.0, n)
    return np.asarray(jrot.axis_angle_to_rot(
        jnp.asarray(axis, jnp.float32), jnp.asarray(theta, jnp.float32)))


def test_make_se3_and_inverse(rng):
    R = random_rotations(rng, 6)
    tr = rng.randn(6, 3).astype(np.float32)
    Tj = np.asarray(jrot.make_se3(jnp.asarray(R), jnp.asarray(tr)))
    Tt = trot.make_se3(t(R), t(tr)).numpy()
    np.testing.assert_array_equal(Tj, Tt)
    np.testing.assert_allclose(np.asarray(jrot.inverse_se3(jnp.asarray(Tj))),
                               trot.inverse_se3(t(Tj)).numpy(), atol=TOL)


def test_angular_distance(rng):
    R1, R2 = random_rotations(rng, 8), random_rotations(rng, 8)
    # degrees; arccos amplifies the f32 rounding of the trace near 0 and
    # 180 deg, and these angles stay away from both
    np.testing.assert_allclose(
        np.asarray(jrot.angular_distance(jnp.asarray(R1), jnp.asarray(R2))),
        trot.angular_distance(t(R1), t(R2)).numpy(), atol=1e-3)


def test_quaternion_to_rot(rng):
    q = rng.randn(10, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_allclose(
        np.asarray(jquat.quaternion_to_rot(jnp.asarray(q))),
        tquat.quaternion_to_rot(t(q)).numpy(), atol=1e-6)


def test_eig4x4_dominant_eigvec(rng):
    A = rng.randn(16, 4, 4).astype(np.float32)
    A = A + A.transpose(0, 2, 1)
    vj = np.asarray(jeig.max_eigvec4x4(jnp.asarray(A)))
    vt = teig.max_eigvec4x4(t(A)).numpy()
    # same eigenvector and the same sign: 8 Jacobi sweeps, same clips
    np.testing.assert_allclose(vj, vt, atol=TOL)
    wj, _ = jeig.eigh4x4(jnp.asarray(A))
    wt, _ = teig.eigh4x4(t(A))
    np.testing.assert_allclose(np.asarray(wj), wt.numpy(), atol=1e-4)


def test_horn_fit_rigid(rng):
    n = 50
    R = random_rotations(rng, 3)
    src = rng.randn(3, n, 3).astype(np.float32)
    tgt = (src @ R.transpose(0, 2, 1) + rng.randn(3, 1, 3)
           + 0.01 * rng.randn(3, n, 3)).astype(np.float32)
    ns = rng.randn(3, n, 3).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    nt = ns @ R.transpose(0, 2, 1)
    w = rng.rand(3, n).astype(np.float32)
    args_j = [jnp.asarray(a) for a in (src, tgt, ns, nt, w, w)]
    args_t = [t(a) for a in (src, tgt, ns, nt, w, w)]
    Rj, tj = jhorn.fit_rigid(*args_j, 0.3)
    Rt, tt = thorn.fit_rigid(*args_t, 0.3)
    np.testing.assert_allclose(np.asarray(Rj), Rt.numpy(), atol=TOL)
    np.testing.assert_allclose(np.asarray(tj), tt.numpy(), atol=TOL)
    np.testing.assert_allclose(
        np.asarray(jhorn.horn87(args_j[0], args_j[1], args_j[4])),
        thorn.horn87(args_t[0], args_t[1], args_t[4]).numpy(), atol=TOL)


def test_masking(rng):
    mj, gj = jmask.observation_mask("second")
    mt, gt = tmask.observation_mask("second", "cpu")
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    np.testing.assert_array_equal(np.asarray(gj), gt.numpy())
    x = rng.rand(2, 160, 640, 7).astype(np.float32)
    for a, b in zip(jmask.apply_mask(jnp.asarray(x), "second"),
                    tmask.apply_mask(t(x), "second")):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for variant in ("eval", "train"):  # the kinect window (ScanNet)
        for a, b in zip(jmask.observation_mask("kinect", variant),
                        tmask.observation_mask("kinect", "cpu", variant)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("dataset", ["suncg", "matterport", "scannet"])
def test_splat_winners_exact(rng, dataset):
    """Many points per pixel: the scatter-max winners (highest index)
    and their payloads must be the same, bit for bit."""
    n = 4000
    pts = rng.randn(n, 3).astype(np.float32)
    vals = rng.randn(n, 4).astype(np.float32)
    valid = rng.rand(n) > 0.1
    pj, dj = jsky.splat_to_pano(jnp.asarray(pts), jnp.asarray(vals),
                                jnp.asarray(valid), dataset, 4)
    pt_, dt_ = tsky.splat_to_pano(t(pts)[None], t(vals)[None],
                                  t(valid)[None], dataset, 4)
    np.testing.assert_array_equal(np.asarray(pj), pt_[0].numpy())
    np.testing.assert_array_equal(np.asarray(dj), dt_[0].numpy())
    assert (dt_ != 0).sum() > 500


@pytest.mark.parametrize("dataset", ["suncg", "matterport"])
def test_pointcloud_lifts(rng, dataset):
    depth = (rng.rand(2, 160, 640) * 3).astype(np.float32)
    depth[:, ::7] = 0.0
    pj, vj = jsky.pano_to_pointcloud(jnp.asarray(depth), dataset)
    pt_, vt = tsky.pano_to_pointcloud(t(depth), dataset)
    np.testing.assert_array_equal(np.asarray(pj), pt_.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    face = depth[:, :, 160:320]
    pj, vj = jsky.face_depth_to_pointcloud(jnp.asarray(face), dataset)
    pt_, vt = tsky.face_depth_to_pointcloud(t(face), dataset)
    np.testing.assert_array_equal(np.asarray(pj), pt_.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())


def test_synthetic_copy_is_identical():
    a, b = jsyn.make_pair(5, "suncg", 0.5), tsyn.make_pair(5, "suncg", 0.5)
    np.testing.assert_array_equal(a[2], b[2])
    for k in a[0]:
        np.testing.assert_array_equal(a[0][k], b[0][k])
        np.testing.assert_array_equal(a[1][k], b[1][k])


@pytest.mark.parametrize("dataset,seed", [("suncg", 3), ("matterport", 4),
                                          ("scannet", 5)])
def test_warp_view(dataset, seed):
    """Warped views equal on a synthetic pair, for a real pose and for the
    exact identity (all zeros, as the original util.py warping does).
    ScanNet warps its 66x88 kinect window."""
    ds, dt, T = tsyn.make_pair(seed, dataset, max_baseline=0.5,
                               full_frames=False)
    mask = "kinect" if dataset == "scannet" else "second"
    views = []
    for d in (ds, dt):
        v, _ = jmake_view(jnp.asarray(d["rgb"]), jnp.asarray(d["norm"]),
                          jnp.asarray(d["depth"]), mask)
        views.append(np.asarray(v))
    vt, _ = tmake_view(t(ds["rgb"]).float()[None], t(ds["norm"]).float()[None],
                       t(ds["depth"]).float()[None], mask)
    np.testing.assert_array_equal(views[0], vt[0].numpy())
    Ts = np.stack([T, np.eye(4)]).astype(np.float32)
    both = np.stack([views[0], views[1]])
    wj = [np.asarray(jwarp.warp_view(jnp.asarray(both[i]), jnp.asarray(Ts[i]),
                                     dataset)) for i in range(2)]
    wt = twarp.warp_view(t(both), t(Ts), dataset).numpy()
    # the 3-term matmuls of the pose may round differently; a pixel whose
    # splat position flips is a real difference, so none may differ here
    np.testing.assert_allclose(wj[0], wt[0], atol=TOL)
    assert (wj[0][..., 7] != 0).sum() > (1000 if mask == "second" else 500)
    assert not wt[1].any() and not wj[1].any()


def test_lift_keypoints(rng):
    depth = (rng.rand(2, 160, 640) * 3 + 0.5).astype(np.float32)
    normal = rng.randn(2, 160, 640, 3).astype(np.float32)
    pts = np.stack([rng.uniform(0, 638.99, (2, 50)),
                    rng.uniform(0, 158.99, (2, 50))], -1).astype(np.float32)
    pc_t, n_t = tsky.lift_keypoints(t(depth), t(normal), t(pts), "suncg")
    for b in range(2):
        pc_j, n_j = jsky.lift_keypoints(jnp.asarray(depth[b]),
                                        jnp.asarray(normal[b]),
                                        jnp.asarray(pts[b]), "suncg")
        np.testing.assert_allclose(np.asarray(pc_j), pc_t[b].numpy(),
                                   atol=TOL)
        np.testing.assert_allclose(np.asarray(n_j), n_t[b].numpy(), atol=TOL)
