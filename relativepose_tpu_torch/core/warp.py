"""Cross-view warping of a partial pano under a pose estimate, batched.

Port of `relativepose_tpu/core/warp.py::warp_view`: lift the observed
region of each view to 3D (the second face for suncg / matterport, the
66x88 kinect window for scannet), transform it by the pose, rotate the
normals, and forward-splat rgb, normal and depth onto the other view's
4-face pano.

View layout (NHWC): [B, 160, 640, 8] with channels
[rgb(3), normal(3), depth(1), valid_mask(1)].
"""

from __future__ import annotations

import torch

from relativepose_tpu_torch import config
from relativepose_tpu_torch.core import skybox

FACE = config.FACE


def _observed_points_and_values(view, dataset: str):
    """Lift the observed region of views [B, H, W, 8] to points + values.

    Returns (points [B, N, 3], values [B, N, 6] (rgb+normal), valid [B, N]).
    """
    ds = config.canonical_dataset(dataset)
    if ds == "scannet":
        block = view[..., config.KINECT_ROW0: config.KINECT_ROW1,
                     config.KINECT_COL0: config.KINECT_COL1, :]
        pts, valid = skybox.kinect_crop_to_pointcloud(block[..., 6])
    else:
        block = view[..., :, FACE: 2 * FACE, :]
        pts, valid = skybox.face_depth_to_pointcloud(block[..., 6], ds)
    vals = block[..., 0:6].reshape(view.shape[:-3] + (-1, 6))
    return pts, vals, valid


def warp_view(view, T, dataset: str):
    """Warp views [B, 160, 640, 8] through rigid transforms T [B, 4, 4].

    T maps each view's camera frame into the other view's frame.  Returns
    [B, 160, 640, 8]: splatted [rgb, rotated normal, splat depth, splat
    mask].  A pair whose T is exactly the identity gets all zeros, as in
    the JAX package.
    """
    pts, vals, valid = _observed_points_and_values(view, dataset)
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    pts_w = pts @ Rt + t[..., None, :]
    nrm_w = vals[..., 3:6] @ Rt
    vals_w = torch.cat([vals[..., 0:3], nrm_w], dim=-1)
    pano, depth = skybox.splat_to_pano(pts_w, vals_w, valid, dataset, 6)
    mask = (depth != 0).to(view.dtype)
    out = torch.cat([pano, depth[..., None], mask[..., None]], dim=-1)
    eye = torch.eye(4, dtype=T.dtype, device=T.device)
    is_identity = torch.all((T - eye).abs().flatten(-2) == 0, dim=-1)
    return torch.where(is_identity[..., None, None, None],
                       torch.zeros_like(out), out)
