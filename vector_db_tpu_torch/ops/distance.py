"""Batched squared-L2 and cosine distances (port of vector_db_tpu/ops/distance.py).

Distances are SQUARED L2 on the device, ``||q||^2 - 2 q.x + ||x||^2``;
``sqrt`` is taken only at the host edge.
"""

from __future__ import annotations

import torch

from vector_db_tpu_torch.device import require_f32_matmul

# Sentinel "infinite" distance of masked entries, paired with id -1.
BIG = 3.0e38
# What a padding or invalid row scores in the block scans (xsq_eff).
PAD_ROW = 2.0e38
# Below this an estimate belongs to a live row.
BIG_THRESH = 1.0e37

_NORM_CHUNK = 65536  # rows per pass: x * x never exists for the whole table


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Row-wise squared L2 norms: f32[N, d] -> f32[N]."""
    if x.shape[0] <= _NORM_CHUNK:
        return (x * x).sum(-1)
    return torch.cat([(c * c).sum(-1) for c in x.split(_NORM_CHUNK)])


def l2_sq_pairwise(q: torch.Tensor, x: torch.Tensor,
                   x_sq: torch.Tensor | None = None) -> torch.Tensor:
    """Squared L2 distance matrix f32[B, d] x f32[N, d] -> f32[B, N], in
    true f32 (raises if CUDA matmuls may use TF32), clamped at 0."""
    require_f32_matmul(x)
    if x_sq is None:
        x_sq = squared_norms(x)
    d = squared_norms(q)[:, None] - 2.0 * (q @ x.T) + x_sq[None, :]
    # guard tiny negatives from cancellation (an exact self-match is 0)
    return d.clamp_min(0.0)


def cosine_distance_pairwise(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cosine distance matrix ``1 - cos(q, x)``: f32[B, N]."""
    require_f32_matmul(x)
    qn = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    xn = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)
    return 1.0 - qn @ xn.T


def exact_rows_sq(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Squared L2 from each query f32[B, d] to its own rows f32[B, R, d]
    -> f32[B, R], unclamped. Products are elementwise f32 (no matmul, so
    TF32 cannot enter): this is the exact-rescore primitive."""
    return ((rows * rows).sum(-1)
            - 2.0 * (rows * queries[:, None, :]).sum(-1)
            + (queries * queries).sum(-1, keepdim=True))


def gather_l2_sq(queries: torch.Tensor, emb: torch.Tensor, idx: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Squared L2 from each query f32[B, d] to its own gathered rows
    ``emb[idx]`` (idx int32[B, K], -1 padded) -> f32[B, K], clamped at 0,
    BIG where ``valid`` (bool[B, K]) is False or idx < 0. The exact rerank
    primitive: elementwise f32 products (:func:`exact_rows_sq`), as the JAX
    version's ``Precision.HIGHEST``."""
    rows = emb[idx.clamp_min(0).long()].float()
    d = exact_rows_sq(queries.float(), rows).clamp_min(0.0)
    return torch.where(valid & (idx >= 0), d, BIG)
