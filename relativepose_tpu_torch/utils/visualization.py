"""Match/keypoint/semantic visualization + point-cloud export.

A copy of `relativepose_tpu/utils/visualization.py` with the palettes of
the port's own `config.py`; `cv2` is imported inside the functions that
draw.  Covers util.py:333-370 (drawMatch/drawKeypoint), the semantic palette
colorization used by the training visual rows
(mainFeatureLearning.py:495-505), util.py:962-968 (pc2obj), and the
min-max normalization helper `vis_norm` (rputil.py:37-41).
"""

from __future__ import annotations

import numpy as np

from relativepose_tpu_torch import config

_COLORS = {"b": (255, 0, 0), "r": (0, 0, 255), "g": (0, 255, 0)}


def draw_match(img0, img1, src, tgt, color="b"):
    """Stack two images vertically and draw correspondence lines
    (util.py:333-361).  src/tgt: [n, 2] (x, y)."""
    import cv2

    if img0.ndim == 2:
        img0 = img0[..., None]
    if img1.ndim == 2:
        img1 = img1[..., None]
    h, w = img0.shape[:2]
    img = np.zeros((2 * h, w, 3), img0.dtype)
    img[:h] = img0
    img[h:] = img1
    n = len(src)
    colors = ([_COLORS[c] for c in color] if isinstance(color, (list, tuple))
              and len(color) == n else [_COLORS[color]] * n)
    for i in range(n):
        p0 = (int(src[i, 0]), int(src[i, 1]))
        p1 = (int(tgt[i, 0]), int(tgt[i, 1]) + h)
        cv2.circle(img, p0, 3, colors[i], -1)
        cv2.circle(img, p1, 3, colors[i], -1)
        cv2.line(img, p0, p1, colors[i], 1)
    return img


def draw_keypoints(img_size, pts):
    """Blank canvas with keypoint dots (util.py:363-370)."""
    import cv2

    ret = np.zeros(tuple(img_size) + (3,), np.uint8)
    for p in np.asarray(pts):
        cv2.circle(ret, (int(p[0]), int(p[1])), 3, (255, 0, 0), -1)
    return ret


def colorize_semantics(labels, dataset: str):
    """Class-index map -> palette RGB image (mainFeatureLearning.py:
    495-505 with config palettes)."""
    palette = config.PALETTES[config.canonical_dataset(dataset)]
    lab = np.clip(np.asarray(labels, np.int64), 0, len(palette) - 1)
    return palette[lab].astype(np.uint8)


def vis_norm(images):
    """Per-image min-max normalize to [0, 1] (rputil.py:37-41)."""
    out = []
    for im in images:
        im = np.asarray(im, np.float32)
        lo, hi = im.min(), im.max()
        out.append((im - lo) / (hi - lo) if hi > lo else im)
    return out


def pc2obj(filepath, pc):
    """Dump a [3, n] pointcloud as a wavefront .obj (util.py:962-968)."""
    pc = np.asarray(pc)
    with open(filepath, "w") as f:
        f.write("# OBJ file\n")
        for v in range(pc.shape[1]):
            f.write("v %.4f %.4f %.4f\n" % (pc[0, v], pc[1, v], pc[2, v]))
