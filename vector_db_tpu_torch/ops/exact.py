"""Exact and mirror-selected k-NN scans (port of vector_db_tpu/ops/exact.py).

The corpus scans run through hand-written kernels on CUDA tensors:
``exact_search``/``exact_search_tiled``/``approx_search_tiled`` through
``l2_topk``, the phase 1 of ``block_select_search_2p`` through
``block_topm_scan`` and that of ``block_select_search_3p`` through
``block_min_scan``. On CPU tensors each kernel wrapper runs its plain
version.

``l2_topk`` keeps its lists in shared memory and takes k <= 256. The three
l2 scans answer for every k, as the JAX functions do: above 256 they branch,
on k alone, to the tiled plain formulation ``l2_topk_plain`` (an f32
product and a top-k merge per corpus tile, what the JAX package's
``exact_search_tiled`` computes), on every device.

Every product under the exact contract (the rescores) is an elementwise
f32 product (``exact_rows_sq``), so TF32 cannot enter. Selection is exact
``torch.topk``: the TPU's ``approx_min_k`` has no CUDA counterpart.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from vector_db_tpu_torch.ops.cuda.block_min import block_min_scan
from vector_db_tpu_torch.ops.cuda.block_topm import block_topm_scan
from vector_db_tpu_torch.ops.cuda.l2_topk import MAX_K, l2_topk, l2_topk_plain
from vector_db_tpu_torch.ops.distance import (
    BIG,
    BIG_THRESH,
    PAD_ROW,
    exact_rows_sq,
    squared_norms,
)


def _l2_scan(queries, emb, valid, k, x_sq=None, tile=65536):
    """``l2_topk`` for k <= 256, its tiled plain version above."""
    if k <= MAX_K:
        return l2_topk(queries, emb, valid, k, x_sq=x_sq, tile=tile)
    if x_sq is None:
        x_sq = squared_norms(emb.float())
    return l2_topk_plain(queries, emb, valid, k, x_sq, tile)


def exact_search(
    queries: torch.Tensor,   # f32[B, d]
    emb: torch.Tensor,       # f32[N, d]
    valid: torch.Tensor,     # bool[N]
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by squared L2: (f32[B, k], int32[B, k]) ascending,
    (BIG, -1) padded when fewer than k rows are valid. k <= 256 runs the
    ``l2_topk`` kernel, a larger k the tiled plain scan."""
    return _l2_scan(queries, emb, valid, k)


def exact_search_tiled(
    queries: torch.Tensor,
    emb: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    tile: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`exact_search` with the plain version streaming ``tile`` rows
    at a time (the kernel never holds more than its tile); the same branch
    on k."""
    return _l2_scan(queries, emb, valid, k, tile=tile)


def approx_search_tiled(
    queries: torch.Tensor,   # f32[B, d]
    emb: torch.Tensor,       # bf16|f32[N, d]
    valid: torch.Tensor,     # bool[N]
    k: int,
    tile: int = 125000,
    x_sq: torch.Tensor | None = None,   # f32[N] norms of the f32 source
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k by squared L2 over a (usually bf16) table.

    The query is cast to the table dtype and scored with f32 sums; ``x_sq``
    should come from the f32 source. Selection is exact (the JAX version's
    ``approx_min_k`` is TPU hardware). Returned distances are bf16-accurate;
    callers needing exact distances re-score with :func:`rescore_exact`.
    k <= 256 runs the ``l2_topk`` kernel, a larger k its tiled plain scan.
    """
    return _l2_scan(queries, emb, valid, k, x_sq=x_sq, tile=tile)


def _final_top_k(
    queries: torch.Tensor, emb: torch.Tensor, cand: torch.Tensor,
    live: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 rescore of candidate rows ``cand`` (only ``live`` ones
    count) and the final ascending top-k, (BIG, -1) padded."""
    d = exact_rows_sq(queries, emb[cand])
    d = torch.where(live, d.clamp_min(0.0), BIG)
    out_d, pos = torch.topk(d, k, dim=1, largest=False, sorted=True)
    out_i = torch.gather(cand, 1, pos).int()
    return out_d, torch.where(out_d < BIG_THRESH, out_i, -1)


def block_select_search_3p(
    queries: torch.Tensor,    # f32[B, dim]
    score_tab: torch.Tensor,  # bf16[N, ds] phase-1/2 table (PCA mirror)
    score_q: torch.Tensor,    # f32[B, ds] queries in score space
    x_sq: torch.Tensor,       # f32[N] full-space row norms
    emb: torch.Tensor,        # f32[N, dim] exact rerank table
    valid: torch.Tensor,      # bool[N]
    k: int,
    block: int = 128,
    blocks_k: int = 0,
    rows_k: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Three-phase block-min scan: phase 1 takes each 128-row block's
    minimum mirror estimate (``block_min_scan``) and keeps the best
    ``blocks_k`` blocks; phase 2 scores every row of those blocks in the
    mirror and keeps the best ``rows_k``; phase 3 rescores those rows
    exactly in f32 and cuts the top k.

    Returns (d_sq f32[B, k], ids int32[B, k]) ascending, (BIG, -1) pad.
    """
    n = emb.shape[0]
    blocks_k = min(blocks_k or 2 * k, math.ceil(n / block))
    rows_k = min(rows_k or 8 * k, blocks_k * block)

    xsq_eff = torch.where(valid, x_sq, PAD_ROW)
    mins = block_min_scan(score_q, score_tab, xsq_eff, block=block)
    bidx = torch.topk(mins, blocks_k, dim=1, largest=False).indices

    # phase 2: mirror estimate of every row of the selected blocks
    row_ids = (bidx[:, :, None] * block
               + torch.arange(block, device=bidx.device)).flatten(1)
    safe = row_ids.clamp(max=n - 1)
    ok = (row_ids < n) & valid[safe]
    sq = score_q.to(score_tab.dtype).float()
    est = x_sq[safe] - 2.0 * torch.bmm(score_tab[safe].float(),
                                       sq[:, :, None])[..., 0]
    est = torch.where(ok, est, BIG)
    rpos = torch.topk(est, rows_k, dim=1, largest=False).indices
    cand = torch.gather(safe, 1, rpos)

    # phase 3: exact rescore of rows_k rows per query
    return _final_top_k(queries, emb, cand, torch.gather(ok, 1, rpos), k)


def block_select_search_2p(
    queries: torch.Tensor,    # f32[B, dim]
    score_tab: torch.Tensor,  # bf16[N, ds] phase-1 mirror table
    score_q: torch.Tensor,    # f32[B, ds] queries in score space
    x_sq: torch.Tensor,       # f32[N] full-space row norms
    emb: torch.Tensor,        # f32[N, dim] exact rerank table
    valid: torch.Tensor,      # bool[N]
    k: int,
    block: int = 128,
    m: int = 4,
    rows_k: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-phase exact search: the per-block top-m scan
    (``block_topm_scan``) emits row candidates, the best ``rows_k`` mirror
    estimates are rescored exactly in f32, and the top k are cut.

    A true top-k row is found iff it is within the best ``m`` mirror rows
    of its own block and the best ``rows_k`` estimates overall.
    Returns (d_sq f32[B, k], ids int32[B, k]) ascending, (BIG, -1) pad.
    """
    n = emb.shape[0]
    xsq_eff = torch.where(valid, x_sq, PAD_ROW)
    est, rows = block_topm_scan(score_q, score_tab, xsq_eff, block=block,
                                m=m)
    rows_k = min(rows_k or 8 * k, est.shape[1])
    ev, pos = torch.topk(est, rows_k, dim=1, largest=False)
    # padding / invalid rows carry estimates >= 1e37 (the xsq_eff mask)
    live = ev < BIG_THRESH
    cand = torch.where(live, torch.gather(rows, 1, pos).clamp(max=n - 1), 0)
    return _final_top_k(queries, emb, cand, live, k)


def knn_exact(
    queries: torch.Tensor,   # f32[B, d], rows OF the corpus
    q_ids: torch.Tensor,     # int32[B] their slots
    emb: torch.Tensor,       # f32[N, d]
    valid: torch.Tensor,     # bool[N]
    k: int,
    tile: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of corpus members against the corpus, excluding self:
    (d_sq f32[B, k], slots int32[B, k]) ascending, (BIG, -1) padded. The
    bulk graph build's primitive: the scan asks for k + 1 (``l2_topk`` on
    CUDA while k + 1 <= 256), drops each query's own slot and keeps k. A
    row that does not find itself (more exact duplicates than k + 1) drops
    its last entry, one of equal distance."""
    d, i = _l2_scan(queries, emb, valid, k + 1, tile=tile)
    is_self = (i == q_ids[:, None]).int()
    keep = torch.sort(is_self, dim=1, stable=True).indices[:, :k]
    return torch.gather(d, 1, keep), torch.gather(i, 1, keep)


def rescore_exact(
    queries: torch.Tensor,   # f32[B, d]
    emb: torch.Tensor,       # f32[capacity, d], the f32 source table
    cand: torch.Tensor,      # int32[B, K] slot ids, -1 padded
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 re-scoring of per-query candidate rows, sorted ascending
    (stable). Returns (f32[B, K], int32[B, K]); a -1 candidate scores BIG."""
    d = exact_rows_sq(queries, emb[cand.clamp_min(0)])
    d = torch.where(cand >= 0, d.clamp_min(0.0), BIG)
    d, order = torch.sort(d, dim=-1, stable=True)
    return d, torch.gather(cand, 1, order)
