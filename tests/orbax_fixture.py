"""Writes the committed orbax fixture `tests/data/orbax_scnet/`.

A seeded SCNet at ngf 2 (the smallest width the CLIs run; the default
224x224 internal size), `torch_parity.flax_scnet_params`, saved as
`{"params": tree, "step": 1}` by the JAX package's `CheckpointManager`
(orbax: OCDBT, zarr v2, zstd) into `checkpoint_0001/`, and beside it
`tests/data/orbax_scnet.json`: each leaf's path, shape, dtype and sha256.
The bytes of the OCDBT files change with every run (uuids, commit times,
file names); the leaves and the JSON do not.

    JAX_PLATFORMS=cpu python tests/orbax_fixture.py
"""

import hashlib
import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "orbax_scnet")
MANIFEST = os.path.join(HERE, "data", "orbax_scnet.json")
NGF = 2


def leaf_digests(tree, prefix=()):
    """{'/'-joined path: {shape, dtype, sha256}} of a nested dict of
    arrays, sorted by path."""
    out = {}
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, dict):
            out.update(leaf_digests(v, path))
        else:
            a = np.ascontiguousarray(np.asarray(v))
            out["/".join(path)] = {
                "shape": list(a.shape), "dtype": a.dtype.str,
                "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return dict(sorted(out.items()))


def main():
    sys.path.insert(0, os.path.dirname(HERE))
    sys.path.insert(0, HERE)
    from relativepose_tpu.models import SCNet
    from relativepose_tpu.utils.checkpoint import CheckpointManager
    from torch_parity import flax_scnet_params

    state = {"params": flax_scnet_params(SCNet(ngf=NGF)),
             "step": np.asarray(1)}
    if os.path.exists(FIXTURE):
        shutil.rmtree(FIXTURE)
    CheckpointManager(FIXTURE).save(1, state)
    with open(MANIFEST, "w") as f:
        json.dump({"ngf": NGF, "leaves": leaf_digests(state)}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
