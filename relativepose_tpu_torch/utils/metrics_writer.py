"""Scalar metrics as JSON lines.

The JAX package's `MetricsWriter` writes TensorBoard event files through
tensorboardX.  The card's machine has no tensorboardX and the port adds no
dependency, so this writer keeps the interface the training drivers use
(`scalars`) and appends one JSON object per call to
`<logdir>/scalars.jsonl`: {"tag": ..., "step": ..., "values": {name:
float}}.
"""

from __future__ import annotations

import json
import os


class MetricsWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "scalars.jsonl")

    def scalars(self, tag: str, values: dict, step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"tag": tag, "step": int(step), "values": {
                k: float(v) for k, v in values.items()}}) + "\n")
