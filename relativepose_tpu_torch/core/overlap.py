"""Point-cloud overlap statistics, batched over pairs.

Port of `relativepose_tpu/core/overlap.py`: bidirectional nearest
neighbours at a 0.08 m threshold, by brute force (a matmul per chunk of
query points, every pair of the batch at once).  Fixed-shape point sets
with validity masks.
"""

from __future__ import annotations

import torch

_BIG = 1e30
_MAX_ELEMS = 1 << 27   # largest [B, chunk, M] distance block (512 MB f32)


def nn_sq_dists(query, qvalid, ref, rvalid, chunk: int = 2048):
    """Least squared distance from each query point to the valid ref
    points of its pair.

    query: [B, N, 3]; ref: [B, M, 3]; masks [B, N] / [B, M] bool.
    Returns [B, N]; invalid queries get 1e30.  Query points go in chunks
    of at most `chunk`, fewer where [B, chunk, M] would pass 2^27
    entries."""
    chunk = max(1, min(chunk, _MAX_ELEMS // max(1, ref.shape[0]
                                                * ref.shape[1])))
    ref_sq = torch.sum(ref * ref, dim=-1)
    ref_pen = torch.where(rvalid, 0.0, _BIG)
    out = []
    for lo in range(0, query.shape[1], chunk):
        qc = query[:, lo: lo + chunk]
        d2 = (torch.sum(qc * qc, dim=-1, keepdim=True)
              - 2.0 * (qc @ ref.transpose(1, 2))
              + ref_sq[:, None, :] + ref_pen[:, None, :])
        out.append(torch.amin(d2, dim=-1))
    mind = torch.cat(out, dim=1)
    return torch.where(qvalid, torch.clamp(mind, min=0.0), _BIG)


def point_cloud_overlap(pc_src, src_valid, pc_tgt, tgt_valid, T_gt,
                        threshold: float = 0.08):
    """Overlap statistics of pairs of scans under their GT relative pose.

    pc_src/pc_tgt: [B, N, 3] / [B, M, 3] with validity masks; T_gt
    [B, 4, 4] maps src into the tgt frame.  Returns a dict of [B] tensors:
    overlap (the larger of the two directional inlier ratios), cam_dist
    (|t_gt|), pc_dist (distance between the cloud means after alignment)
    and pc_nn (mean of the two least NN distances)."""
    R, t = T_gt[:, :3, :3], T_gt[:, :3, 3]
    src_in_tgt = pc_src @ R.transpose(1, 2) + t[:, None]
    d2_s2t = nn_sq_dists(src_in_tgt, src_valid, pc_tgt, tgt_valid)
    n_src = torch.clamp(torch.sum(src_valid, dim=-1), min=1)
    overlap_s2t = torch.sum((d2_s2t < threshold**2) & src_valid,
                            dim=-1) / n_src
    nns2t = torch.sqrt(torch.amin(torch.where(src_valid, d2_s2t, _BIG),
                                  dim=-1))

    tgt_in_src = (pc_tgt - t[:, None]) @ R
    d2_t2s = nn_sq_dists(tgt_in_src, tgt_valid, pc_src, src_valid)
    n_tgt = torch.clamp(torch.sum(tgt_valid, dim=-1), min=1)
    overlap_t2s = torch.sum((d2_t2s < threshold**2) & tgt_valid,
                            dim=-1) / n_tgt
    nnt2s = torch.sqrt(torch.amin(torch.where(tgt_valid, d2_t2s, _BIG),
                                  dim=-1))

    w_src = src_valid.to(pc_src.dtype)
    w_tgt = tgt_valid.to(pc_tgt.dtype)
    mean_src = torch.sum(src_in_tgt * w_src[..., None], 1) / torch.clamp(
        torch.sum(w_src, -1), min=1.0)[:, None]
    mean_tgt = torch.sum(pc_tgt * w_tgt[..., None], 1) / torch.clamp(
        torch.sum(w_tgt, -1), min=1.0)[:, None]
    return {
        "overlap": torch.maximum(overlap_s2t, overlap_t2s),
        "cam_dist": torch.linalg.vector_norm(t, dim=-1),
        "pc_dist": torch.linalg.vector_norm(mean_src - mean_tgt, dim=-1),
        "pc_nn": 0.5 * (nns2t + nnt2s),
    }
