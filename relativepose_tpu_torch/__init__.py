"""relativepose_tpu_torch — the PyTorch/CUDA port of relativepose_tpu.

The JAX package `relativepose_tpu` is the reference; this package mirrors
its subpackage and module names (config, core, ops, match, models,
pipeline, data, train, eval, utils, cli) and imports nothing of it.
Tensors are batched over a leading pano-pair dimension, NHWC at the
public functions.  Entry points run on CUDA unless the caller passes
`device="cpu"` (the CLIs: `--device cpu`).

The two Pallas TPU kernels of the reference are hand-written CUDA kernels
here (`ops/kernels.py`, sources in `csrc/`), built with nvcc at first use.
"""
