"""Observation masks for partial panoramas.

Port of `relativepose_tpu/core/masking.py`: the 'second' method observes
the second 160x160 face of the pano, and `geow` is the exp distance
weight outside it; the 'kinect' method (ScanNet) observes the 66x88
window centred in the second face.  NHWC layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from relativepose_tpu_torch import config

FACE = config.FACE


@functools.lru_cache(maxsize=None)
def _second_mask_np(h: int = config.PANO_HEIGHT, w: int = config.PANO_WIDTH):
    mask = np.zeros((h, w), dtype=np.float32)
    mask[:, FACE: 2 * FACE] = 1.0
    _, xs = np.meshgrid(range(h), range(w), indexing="ij")
    dist = np.stack(
        [np.abs(xs - FACE), np.abs(xs - 2 * FACE),
         np.abs(xs - w - FACE), np.abs(xs - w - 2 * FACE)], 0
    ).min(0) / float(FACE)
    geow = np.exp(-dist / (2.0 * config.SECOND_MASK_SIGMA**2)).astype(
        np.float32)
    geow[:, FACE: 2 * FACE] = 0.0
    return mask, geow


@functools.lru_cache(maxsize=None)
def _kinect_mask_np(h: int = config.PANO_HEIGHT, w: int = config.PANO_WIDTH):
    mask = np.zeros((h, w), dtype=np.float32)
    mask[config.KINECT_ROW0: config.KINECT_ROW1,
         config.KINECT_COL0: config.KINECT_COL1] = 1.0
    return mask


def observation_mask(method: str, device="cuda", variant: str = "eval"):
    """The [H, W] observation mask and geow of a mask method.

    For 'kinect', variant 'eval' gives geow = 1 - mask and 'train' gives
    20 inside the window and 1 outside; 'second' has one geow."""
    if method == "second":
        mask, geow = _second_mask_np()
    elif method == "kinect":
        mask = _kinect_mask_np()
        if variant == "train":
            geow = mask * 20.0 + (1.0 - mask)
        else:
            geow = 1.0 - mask
    else:
        raise ValueError(f"unknown maskMethod {method!r}")
    return (torch.from_numpy(mask).to(device),
            torch.from_numpy(geow).to(device))


def apply_mask(x, method: str, variant: str = "eval"):
    """Mask a pano tensor x [..., H, W, C].

    Returns (masked_x, mask [..., H, W, 1], geow [..., H, W, 1]) broadcast
    over the leading batch dimensions.
    """
    mask, geow = observation_mask(method, x.device, variant)
    mask = mask[..., None].to(x.dtype)
    geow = geow[..., None].to(x.dtype)
    bshape = x.shape[:-3]
    return (x * mask, mask.expand(bshape + mask.shape),
            geow.expand(bshape + geow.shape))
