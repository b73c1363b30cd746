"""Matching-primitive extraction, batched over pairs.

Port of `relativepose_tpu/match/primitives.py::extract_primitives`:
keypoints -> (3D position, normal, descriptor, weight, valid) sets ready
for the solver, lifted through the composited depth/normal maps.
"""

from __future__ import annotations

import torch

from relativepose_tpu_torch import config
from relativepose_tpu_torch.core import skybox
from relativepose_tpu_torch.match import keypoints as kp
from relativepose_tpu_torch.ops.interpolate import interpolate_normalized

H, W = config.PANO_HEIGHT, config.PANO_WIDTH


def extract_primitives(rgb_s, rgb_t, depth_s, depth_t, normal_s, normal_t,
                       feat_s, feat_t, kp_cfg, dataset: str,
                       mask_method: str = "second",
                       do_completion: bool = True, gray_full_s=None,
                       gray_full_t=None, det_s=None, det_t=None,
                       draws=None):
    """Returns (data_s, data_t) solver-ready dicts (pc/normal/feat/weight/
    valid), each with [B, kp_cfg.capacity] rows.

    With `do_completion` False, keypoints outside the observed region are
    invalidated.  gray_full_s/t: ScanNet full frames for detection;
    det_s/det_t: precomputed `keypoints.detect_observed` results; draws:
    `keypoints.KeypointDraws`.
    """
    pts_s, valid_s, w_s, pts_t, valid_t, w_t = kp.build_keypoint_sets(
        rgb_s, rgb_t, feat_s, feat_t, kp_cfg, mask_method,
        gray_full_s=gray_full_s, gray_full_t=gray_full_t, det_s=det_s,
        det_t=det_t, draws=draws)

    pc_s, nrm_s = skybox.lift_keypoints(depth_s, normal_s, pts_s, dataset)
    pc_t, nrm_t = skybox.lift_keypoints(depth_t, normal_t, pts_t, dataset)

    norm_xy = torch.tensor([W, H], dtype=pts_s.dtype, device=pts_s.device)
    desc_s = interpolate_normalized(feat_s, pts_s / norm_xy)
    desc_t = interpolate_normalized(feat_t, pts_t / norm_xy)

    if not do_completion:
        valid_s = valid_s & (w_s == 1.0)
        valid_t = valid_t & (w_t == 1.0)

    data_s = dict(pc=pc_s, normal=nrm_s, feat=desc_s, weight=w_s,
                  valid=valid_s)
    data_t = dict(pc=pc_t, normal=nrm_t, feat=desc_t, weight=w_t,
                  valid=valid_t)
    return data_s, data_t
