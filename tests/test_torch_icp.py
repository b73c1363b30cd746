"""ops/icp.py of relativepose_tpu_torch against relativepose_tpu, on the CPU.

Tolerances: projected pixel indices and `ok` masks are integer results
and must be equal; lifted points are held to 1e-6 relative (the scannet
lift divides once); polished poses to 1e-4 (Gauss-Newton sums over 1e5
pixels in another order, then a 6x6 solve), the bound of the pose tests in
tests/test_torch_solver.py.

Two faults of the JAX package (ADVICE.md) are reproduced on purpose and
checked here: `project_to_pano` lacks the kinect factors, so the scannet
lift -> project round trip is biased; `icp_polish` never reads `nrm_s`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relativepose_tpu.ops import icp as jicp
from relativepose_tpu_torch.core.rotation import angular_distance
from relativepose_tpu_torch.data import synthetic
from relativepose_tpu_torch.ops import icp as ticp
from torch_parity import one_torch_thread  # noqa: F401

H, W = 160, 640


def t(x):
    return torch.from_numpy(np.array(x))


def perturb(T_gt, rng, rot_deg, trans_m):
    """T_gt moved by a rotation of rot_deg about a random axis and a
    translation of trans_m (tests/test_icp.py's perturbation)."""
    ax = rng.randn(3)
    ax /= np.linalg.norm(ax)
    th = np.deg2rad(rot_deg)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                  [-ax[1], ax[0], 0]])
    Rd = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    dt = rng.randn(3)
    dt *= trans_m / np.linalg.norm(dt)
    T = np.array(T_gt, dtype=np.float64).copy()
    T[:3, :3] = Rd @ T[:3, :3]
    T[:3, 3] = Rd @ T[:3, 3] + dt
    return T.astype(np.float32)


@pytest.mark.parametrize("dataset", ["suncg", "matterport", "scannet"])
def test_project_to_pano_matches_jax(rng, dataset):
    pts = (rng.randn(2, 3000, 3) * 2).astype(np.float32)
    valid = rng.rand(2, 3000) > 0.1
    ft, okt = ticp.project_to_pano(t(pts), t(valid), dataset)
    for b in range(2):
        fj, okj = jicp.project_to_pano(jnp.asarray(pts[b]),
                                       jnp.asarray(valid[b]), dataset)
        np.testing.assert_array_equal(np.asarray(fj), ft[b].numpy())
        np.testing.assert_array_equal(np.asarray(okj), okt[b].numpy())
    assert 0.5 < okt.float().mean() < 0.95  # some points above or below


@pytest.fixture(scope="module")
def depths():
    return {ds: synthetic.make_pair(7, ds, full_frames=False)[0]["depth"]
            for ds in ("suncg", "scannet")}


@pytest.mark.parametrize("dataset", ["suncg", "scannet"])
def test_lift_project_roundtrip(depths, dataset):
    """Each pixel's own lifted point projects back to that pixel for
    suncg (tests/test_icp.py:37).  For scannet the lift divides by the
    kinect factors and the projection does not multiply them back (the
    JAX package's fault, kept): most pixels land elsewhere, on the same
    pixels in both packages."""
    depth = depths[dataset]
    pts, valid = ticp.pano_points_image(t(depth)[None], dataset)
    pj, vj = jicp.pano_points_image(jnp.asarray(depth), dataset)
    np.testing.assert_allclose(np.asarray(pj), pts[0].numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(np.asarray(vj), valid[0].numpy())
    flat, ok = ticp.project_to_pano(pts.reshape(1, -1, 3),
                                    valid.reshape(1, -1), dataset)
    fj, okj = jicp.project_to_pano(pj.reshape(-1, 3), vj.reshape(-1),
                                   dataset)
    np.testing.assert_array_equal(np.asarray(fj), flat[0].numpy())
    np.testing.assert_array_equal(np.asarray(okj), ok[0].numpy())
    flat, ok = flat[0].numpy(), ok[0].numpy()
    own = np.arange(H * W)
    assert ok.mean() > 0.98
    same = (flat[ok] == own[ok]).mean()
    if dataset == "suncg":
        assert same == 1.0
    else:
        assert same < 0.1


@pytest.fixture(scope="module")
def icp_pairs():
    """Two suncg pairs with poses moved off the truth."""
    rng = np.random.RandomState(0)
    pairs = [synthetic.make_pair(s, "suncg", max_baseline=0.3)
             for s in (11, 13)]
    T_gt = np.stack([p[2] for p in pairs]).astype(np.float32)
    T0 = np.stack([perturb(T_gt[0], rng, 1.5, 0.15),
                   perturb(T_gt[1], rng, 1.0, 0.2)])
    geo = {k: np.stack([p[v][key] for p in pairs]).astype(np.float32)
           for k, v, key in (("dep_s", 0, "depth"), ("nrm_s", 0, "norm"),
                             ("dep_t", 1, "depth"), ("nrm_t", 1, "norm"))}
    return T_gt, T0, geo


def _polish_both(T0, geo, **kw):
    tkw = {k: (t(v) if k.startswith("obs") else v) for k, v in kw.items()}
    Tt = ticp.icp_polish(t(T0), t(geo["dep_s"]), t(geo["nrm_s"]),
                         t(geo["dep_t"]), t(geo["nrm_t"]), "suncg", **tkw)
    Tj = []
    for b in range(T0.shape[0]):
        jkw = {k: (jnp.asarray(v[b]) if k.startswith("obs") else v)
               for k, v in kw.items()}
        Tj.append(np.asarray(jicp.icp_polish(
            jnp.asarray(T0[b]), *[jnp.asarray(geo[k][b]) for k in
                                  ("dep_s", "nrm_s", "dep_t", "nrm_t")],
            "suncg", **jkw)))
    return np.stack(Tj), Tt.numpy()


def rot_err(A, B):
    return angular_distance(t(A[:, :3, :3]), t(B[:, :3, :3])).numpy()


def trans_err(A, B):
    return np.linalg.norm(A[:, :3, 3] - B[:, :3, 3], axis=-1)


@pytest.mark.parametrize("dof", [6, 3])
def test_icp_polish_matches_jax(icp_pairs, dof):
    """Mirrors tests/test_icp.py:50-79 on two pairs at once: 6-dof halves
    the rotation and translation errors; 3-dof keeps the rotation exactly
    and halves the translation error."""
    T_gt, T0, geo = icp_pairs
    Tj, Tt = _polish_both(T0, geo, iters=10, dof=dof)
    np.testing.assert_allclose(Tj, Tt, atol=1e-4)
    assert (trans_err(Tt, T_gt) < 0.5 * trans_err(T0, T_gt)).all()
    if dof == 6:
        assert (rot_err(Tt, T_gt) < 0.5 * rot_err(T0, T_gt)).all()
    else:
        np.testing.assert_array_equal(Tt[:, :3, :3], T0[:, :3, :3])


def test_icp_polish_with_observation_masks(icp_pairs):
    """The pipeline's call: observed-region masks weight the
    associations; the polish still agrees with the JAX package."""
    _, T0, geo = icp_pairs
    obs = np.zeros((2, H, W), np.float32)
    obs[:, :, 160:320] = 1.0
    Tj, Tt = _polish_both(T0, geo, iters=5, obs_s=obs, obs_t=obs)
    np.testing.assert_allclose(Tj, Tt, atol=1e-4)
    assert not np.allclose(Tt, T0)


def test_guard_and_unused_source_normals(icp_pairs):
    """All-invalid target geometry: the support guard leaves the input
    pose bit-unchanged (tests/test_icp.py:81).  And nrm_s is never read
    (the JAX package's fault, kept): garbage source normals give the same
    pose, bit for bit."""
    _, T0, geo = icp_pairs
    zero = dict(geo, dep_t=np.zeros_like(geo["dep_t"]),
                nrm_t=np.zeros_like(geo["nrm_t"]))
    _, Tt = _polish_both(T0, zero, iters=5)
    np.testing.assert_array_equal(Tt, T0)
    a = ticp.icp_polish(t(T0), t(geo["dep_s"]), t(geo["nrm_s"]),
                        t(geo["dep_t"]), t(geo["nrm_t"]), "suncg", iters=3)
    b = ticp.icp_polish(t(T0), t(geo["dep_s"]),
                        torch.full_like(t(geo["nrm_s"]), float("nan")),
                        t(geo["dep_t"]), t(geo["nrm_t"]), "suncg", iters=3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_rodrigues_small_angle_branch():
    """Below 1e-6 rad the series I + [omega]x, above it the closed form;
    omega = 0 gives the identity exactly."""
    omega = torch.tensor([[0.0, 0.0, 0.0], [1e-8, -2e-8, 3e-8],
                          [0.1, -0.05, 0.02]])
    R = ticp.rodrigues(omega)
    torch.testing.assert_close(R[0], torch.eye(3), rtol=0, atol=0)
    torch.testing.assert_close(R[1], torch.eye(3) + ticp._skew(omega[1:2])[0],
                               rtol=0, atol=0)
    torch.testing.assert_close(R[2] @ R[2].T, torch.eye(3), atol=1e-6,
                               rtol=0)
    assert float(angular_distance(R[2], torch.eye(3))) == pytest.approx(
        np.rad2deg(np.linalg.norm([0.1, -0.05, 0.02])), rel=1e-4)
