"""Shared CLI helpers: the part of `relativepose_tpu/cli/common.py` that
the evaluation driver needs."""

from __future__ import annotations


def parse_internal_size(s: str) -> tuple:
    """'224x224' / '160,320' -> (224, 224) / (160, 320)."""
    parts = s.replace("x", ",").split(",")
    hw = tuple(int(p) for p in parts)
    assert len(hw) == 2 and all(v % 32 == 0 and v >= 64 for v in hw), (
        f"internal_size must be two multiples of 32 >= 64, got {s}")
    return hw
