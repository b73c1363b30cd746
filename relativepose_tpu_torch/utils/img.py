"""2-D image crop / affine transform / gaussian heatmap utilities.

A copy of `relativepose_tpu/utils/img.py` (numpy; `cv2` is imported by
`crop` alone, when it runs).  Covers the reference's utils/img.py:5-174 (GetTransform / Transform / Crop
/ DrawGaussian).  Only `Crop` is consumed by the dataset path in the
reference (datasets/SUNCG.py:10); the rest are provided for API parity.
"""

from __future__ import annotations

import numpy as np


def get_transform(center, scale, rot, res):
    """Affine matrix mapping the `scale`-sized box at `center` to a
    res x res crop, rotated by `rot` radians (img.py:5-44)."""
    h = scale
    t = np.eye(3)
    t[0, 0] = res / h
    t[1, 1] = res / h
    t[0, 2] = res * (-center[0] / h + 0.5)
    t[1, 2] = res * (-center[1] / h + 0.5)
    if rot != 0:
        rot_mat = np.eye(3)
        c, s = np.cos(rot), np.sin(rot)
        rot_mat[:2, :2] = [[c, -s], [s, c]]
        t_center = np.eye(3)
        t_center[:2, 2] = [-res / 2, -res / 2]
        t = np.linalg.inv(t_center) @ rot_mat @ t_center @ t
    return t


def transform_point(pt, center, scale, rot, res, invert=False):
    """Map a point through get_transform (img.py:46-60)."""
    t = get_transform(center, scale, rot, res)
    if invert:
        t = np.linalg.inv(t)
    v = t @ np.array([pt[0], pt[1], 1.0])
    return v[:2].astype(int)


def crop(img, center, scale, rot, res):
    """Crop a rotated, scaled window into a res x res image
    (img.py:62-140), zero-padded out of bounds."""
    import cv2

    t = get_transform(center, scale, rot, res)
    return cv2.warpAffine(
        img, t[:2], (res, res), flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_CONSTANT)


def draw_gaussian(heatmap, center, sigma):
    """Additively splat a gaussian blob (img.py:156-174)."""
    h, w = heatmap.shape[:2]
    tmp_size = int(3 * sigma)
    ul = [int(center[0]) - tmp_size, int(center[1]) - tmp_size]
    br = [int(center[0]) + tmp_size + 1, int(center[1]) + tmp_size + 1]
    if ul[0] >= w or ul[1] >= h or br[0] < 0 or br[1] < 0:
        return heatmap
    size = 2 * tmp_size + 1
    x = np.arange(size, dtype=np.float32)
    y = x[:, None]
    x0 = y0 = size // 2
    g = np.exp(-((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma**2))
    gx = max(0, -ul[0]), min(br[0], w) - ul[0]
    gy = max(0, -ul[1]), min(br[1], h) - ul[1]
    ix = max(0, ul[0]), min(br[0], w)
    iy = max(0, ul[1]), min(br[1], h)
    heatmap[iy[0]:iy[1], ix[0]:ix[1]] = np.maximum(
        heatmap[iy[0]:iy[1], ix[0]:ix[1]], g[gy[0]:gy[1], gx[0]:gx[1]])
    return heatmap
