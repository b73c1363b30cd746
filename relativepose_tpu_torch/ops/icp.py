"""Dense projective point-to-plane ICP polish of the estimated pose.

Port of `relativepose_tpu/ops/icp.py`, batched over pairs.  The solver's
translation inherits the mean position error of its C=1720 keypoint
correspondences; this polishes each pair's pose against the dense
composited panos (observed pixels carry ground-truth geometry, the others
the completed geometry): about 100k point-to-plane constraints, associated
by projection (a gather, no nearest-neighbour search), in a fixed number
of guarded Gauss-Newton steps.  Off by default (`PipelineConfig.icp_iters
= 0`).

Two faults of the JAX package are reproduced, so that both packages give
the same poses:
  * `project_to_pano` projects without the kinect intrinsics factors that
    the scannet lift (`skybox.pano_to_pointcloud`) divides by, so for
    scannet the lift -> project round trip does not return a pixel to
    itself;
  * `icp_polish` takes the source normals `nrm_s` and never reads them
    (point-to-plane uses the target normals only).

T maps the source view's frame into the target view's frame.
"""

from __future__ import annotations

import torch

from relativepose_tpu_torch.core import skybox

FACE = skybox.FACE


def pano_points_image(depth, dataset: str):
    """Lift pano depth maps to per-pixel points in image layout.

    depth: [B, FACE, 4*FACE] -> (points [B, FACE, 4*FACE, 3], valid
    [B, FACE, 4*FACE]): `skybox.pano_to_pointcloud`'s face-major order
    put back into row-major pixels, so that flat indices line up with
    `project_to_pano`."""
    pts, valid = skybox.pano_to_pointcloud(depth, dataset)
    b, h = depth.shape[0], FACE
    pts = pts.reshape(b, 4, h, h, 3).transpose(1, 2).reshape(b, h, 4 * h, 3)
    valid = valid.reshape(b, 4, h, h).transpose(1, 2).reshape(b, h, 4 * h)
    return pts, valid


def project_to_pano(points, valid, dataset: str):
    """Nearest-pixel projection of points [B, N, 3] in a view's frame onto
    its pano: (flat row-major pixel index [B, N], ok [B, N]).  Invalid or
    unseen points get index 0 with ok False."""
    v, u, ok, _ = skybox.project_to_faces(points, valid, dataset)
    return torch.where(ok, v * (4 * FACE) + u, 0), ok


def _take(x, idx):
    """x [B, N, ...] at idx [B, M] -> [B, M, ...]."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def _skew(w):
    """[B, 3] -> the cross-product matrices [B, 3, 3]."""
    z = torch.zeros_like(w[:, 0])
    return torch.stack([
        torch.stack([z, -w[:, 2], w[:, 1]], -1),
        torch.stack([w[:, 2], z, -w[:, 0]], -1),
        torch.stack([-w[:, 1], w[:, 0], z], -1)], -2)


def rodrigues(omega):
    """Rotations [B, 3, 3] of the axis-angle vectors omega [B, 3]; below
    an angle of 1e-6 the first-order series I + [omega]x."""
    theta = torch.sqrt(torch.sum(omega * omega, -1) + 1e-24)
    kx = _skew(omega / theta[:, None])
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    s, c = torch.sin(theta)[:, None, None], torch.cos(theta)[:, None, None]
    R = eye + s * kx + (1.0 - c) * (kx @ kx)
    small = (theta < 1e-6)[:, None, None]
    return torch.where(small, eye + _skew(omega), R)


def icp_polish(T, dep_s, nrm_s, dep_t, nrm_t, dataset: str,
               iters: int = 5, sigma: float = 0.10,
               max_residual: float = 0.5, dof: int = 6,
               max_rot_step: float = 0.15, max_trans_step: float = 0.5,
               obs_s=None, obs_t=None, halluc_weight: float = 0.05,
               anchor: float = 0.03):
    """Polish poses T [B, 4, 4] with projective point-to-plane ICP.

    dep_*: [B, FACE, 4*FACE] composited depth; nrm_*: [B, FACE, 4*FACE, 3]
    composited normals (`nrm_s` is not read, as in the JAX package).
    `dof=6` solves the full twist; `dof=3` keeps the rotation and refines
    the translation only.  Geman-McClure weights of scale `sigma` (m);
    associations with |residual| > max_residual are dropped.  obs_s/obs_t:
    optional [B, FACE, 4*FACE] observed-region masks; each association is
    weighted by obs + halluc_weight * (1 - obs) at both ends.  `anchor`
    is a Tikhonov prior toward the initial pose.  A step that is not
    finite, too large, or has a support weight of 32 or less leaves that
    pair's pose unchanged.
    """
    b = T.shape[0]
    P_s, v_s = pano_points_image(dep_s, dataset)
    P_t, v_t = pano_points_image(dep_t, dataset)
    p_s = P_s.reshape(b, -1, 3)
    valid_s = v_s.reshape(b, -1)
    p_t = P_t.reshape(b, -1, 3)
    valid_t = v_t.reshape(b, -1)
    n_t = nrm_t.reshape(b, -1, 3)
    s2 = sigma * sigma
    ones = torch.ones(valid_s.shape, dtype=p_s.dtype, device=p_s.device)
    ow_s = ones if obs_s is None else \
        obs_s.reshape(b, -1) + halluc_weight * (1.0 - obs_s.reshape(b, -1))
    ow_t = ones if obs_t is None else \
        obs_t.reshape(b, -1) + halluc_weight * (1.0 - obs_t.reshape(b, -1))
    k = 6 if dof == 6 else 3
    eye_k = torch.eye(k, dtype=p_s.dtype, device=p_s.device)
    R0, t0 = T[:, :3, :3], T[:, :3, 3]

    for _ in range(iters):
        R, t = T[:, :3, :3], T[:, :3, 3]
        q = p_s @ R.transpose(1, 2) + t[:, None]
        idx, ok = project_to_pano(q, valid_s, dataset)
        pt = _take(p_t, idx)
        nt = _take(n_t, idx)
        r = torch.sum(nt * (q - pt), -1)
        good = ok & _take(valid_t, idx) & (r.abs() < max_residual)
        w = good.to(q.dtype) * (s2 / (s2 + r * r)) * ow_s * _take(ow_t, idx)
        jac = torch.cat([torch.linalg.cross(q, nt, dim=-1), nt], -1) \
            if dof == 6 else nt
        a = (jac * w[..., None]).transpose(1, 2) @ jac
        rhs = -(jac.transpose(1, 2) @ (w * r)[..., None])[..., 0]
        wsum = torch.sum(w, -1) + 1e-12
        # first-order twist pulling the current pose back to the initial
        R_rel = R0 @ R.transpose(1, 2)
        w_err = 0.5 * torch.stack([R_rel[:, 2, 1] - R_rel[:, 1, 2],
                                   R_rel[:, 0, 2] - R_rel[:, 2, 0],
                                   R_rel[:, 1, 0] - R_rel[:, 0, 1]], -1)
        t_err = t0 - t
        prior = torch.cat([w_err, t_err], -1) if dof == 6 else t_err
        a = a / wsum[:, None, None] + (anchor + 1e-6) * eye_k
        # solve_ex: a pair whose system is not finite gets a non-finite
        # step, which the guard below rejects, instead of an exception
        delta = torch.linalg.solve_ex(
            a, rhs / wsum[:, None] + anchor * prior)[0]
        if dof == 6:
            omega, nu = delta[:, :3], delta[:, 3:]
        else:
            omega, nu = torch.zeros_like(delta), delta
        ok_step = (
            torch.isfinite(omega).all(-1) & torch.isfinite(nu).all(-1)
            & (torch.sqrt(torch.sum(omega * omega, -1)) < max_rot_step)
            & (torch.sqrt(torch.sum(nu * nu, -1)) < max_trans_step)
            & (wsum > 32.0))
        Rd = rodrigues(omega)
        T2 = torch.eye(4, dtype=T.dtype, device=T.device).repeat(b, 1, 1)
        T2[:, :3, :3] = Rd @ R
        T2[:, :3, 3] = (Rd @ t[..., None])[..., 0] + nu
        T = torch.where(ok_step[:, None, None], T2, T)
    return T
