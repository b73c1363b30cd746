"""eval/descriptor_eval.py of relativepose_tpu_torch against
relativepose_tpu, on the CPU.  The JAX package draws the sampled
correspondences from a key; the same indices are handed to the port.
Ratios are counts over H*W locations of distances below the true match's,
and the two packages compute the distances as |a|^2 - 2ab + |b|^2 in
another summation order: a location whose distance is within rounding of
the true match's may flip, so ratios agree to 2 / (H*W)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from relativepose_tpu.eval import descriptor_eval as jde
from relativepose_tpu_torch.eval import descriptor_eval as tde
from torch_parity import one_torch_thread  # noqa: F401

H, W, C, N, K, S = 24, 40, 8, 3, 50, 30


def inputs(rng):
    fs = rng.randn(N, H, W, C).astype(np.float32)
    ft = (fs + 0.7 * rng.randn(N, H, W, C)).astype(np.float32)
    idx_s = np.stack([rng.randint(0, W, (N, K)), rng.randint(0, H, (N, K))],
                     -1).astype(np.int32)
    idx_t = np.stack([rng.randint(0, W, (N, K)), rng.randint(0, H, (N, K))],
                     -1).astype(np.int32)
    return fs, ft, idx_s, idx_t


def jax_sel(key):
    return np.array(jax.random.randint(key, (N, S), 0, K))


def test_ranking_ratio_with_jax_samples(rng):
    fs, ft, idx_s, idx_t = inputs(rng)
    key = jax.random.PRNGKey(3)
    valid = np.array([1, 0, 1], np.int32)
    rj, vj = jde.ranking_ratio(*map(jnp.asarray, (fs, ft, idx_s, idx_t,
                                                  valid)), sample=S, key=key)
    rt, vt = tde.ranking_ratio(*map(torch.from_numpy, (fs, ft, idx_s, idx_t,
                                                       valid)),
                               sel=torch.from_numpy(jax_sel(key)))
    assert rt.shape == (N, S)
    np.testing.assert_allclose(np.asarray(rj), rt.numpy(), rtol=0,
                               atol=2.0 / (H * W))
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    # sampled from a generator when no indices are given
    r2, _ = tde.ranking_ratio(*map(torch.from_numpy, (fs, ft, idx_s, idx_t,
                                                      valid)), sample=S,
                              generator=torch.Generator().manual_seed(0))
    assert r2.shape == (N, S) and bool(((r2 >= 0) & (r2 <= 1)).all())


def test_observe_type_exact(rng):
    mask = (rng.rand(N, H, W) > 0.5).astype(np.float32)
    _, _, idx_s, idx_t = inputs(rng)
    yj = jde.observe_type(*map(jnp.asarray, (mask, idx_s, idx_t)))
    yt = tde.observe_type(*map(torch.from_numpy, (mask, idx_s, idx_t)))
    np.testing.assert_array_equal(np.asarray(yj), yt.numpy())
    assert set(np.unique(yt.numpy())) <= {0.0, 1.0, 2.0}


def test_bucketed_ratios(rng):
    fs, ft, idx_s, idx_t = inputs(rng)
    mask = np.zeros((N, H, W), np.float32)
    mask[:, :, : W // 2] = 1.0
    valid = np.array([1, 1, 0], np.int32)
    key = jax.random.PRNGKey(5)
    oj = jde.bucketed_ratios(
        jnp.asarray(fs), jnp.asarray(ft),
        {"idx_src": jnp.asarray(idx_s), "idx_tgt": jnp.asarray(idx_t),
         "valid": jnp.asarray(valid)}, jnp.asarray(mask), key=key,
        sample=S)
    ot = tde.bucketed_ratios(
        torch.from_numpy(fs), torch.from_numpy(ft),
        {"idx_src": torch.from_numpy(idx_s),
         "idx_tgt": torch.from_numpy(idx_t),
         "valid": torch.from_numpy(valid)}, torch.from_numpy(mask),
        sel=torch.from_numpy(jax_sel(key)))
    assert len(oj["obs"]) == len(ot["obs"]) > 0
    assert len(oj["unobs"]) == len(ot["unobs"]) > 0
    assert len(ot["obs"]) + len(ot["unobs"]) == 2 * S
    for b in ("obs", "unobs"):
        np.testing.assert_allclose(oj[b], ot[b], rtol=0, atol=1e-6)
