"""Exact and mirror-selected k-NN scans (port of vector_db_tpu/ops/exact.py).

The corpus scans run through hand-written kernels on CUDA tensors:
``exact_search``/``exact_search_tiled``/``approx_search_tiled`` through
``l2_topk``, the phase 1 of ``block_select_search_2p`` through
``block_topm_scan`` and that of ``block_select_search_3p`` through
``block_min_scan``. On CPU tensors each kernel wrapper runs its plain
version.

``l2_topk`` keeps its lists in shared memory, 256 to a query. The three
l2 scans answer for every k, as the JAX functions do, past 256, a
CUDA tensor takes passes of the kernel, each from where the last one's
list ended (``ops.cuda.by_passes``); a CPU tensor the tiled plain
formulation ``l2_topk_plain`` (an f32 product and a top-k merge per corpus
tile, what the JAX package's ``exact_search_tiled`` computes).

``block_select_search`` (the two-phase block-min scan of
``HNSW.search_batch_scan(mode="blocksel")``) is plain XLA in the JAX
package, with no Pallas kernel, and plain torch here.

Every product under the exact contract (the rescores, an ``exact_phase1``)
is true f32: elementwise (``exact_rows_sq``), or a matmul behind
``require_f32_matmul``, so TF32 cannot enter. Selection is exact: the
TPU's ``approx_min_k`` has no CUDA counterpart.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from vector_db_tpu_torch.device import require_f32_matmul
from vector_db_tpu_torch.ops.cuda.block_min import block_min_scan
from vector_db_tpu_torch.ops.cuda.block_topm import block_topm_scan
from vector_db_tpu_torch.ops.cuda import by_passes
from vector_db_tpu_torch.ops.cuda.l2_topk import MAX_K, l2_topk, l2_topk_plain
from vector_db_tpu_torch.ops.distance import (
    BIG,
    BIG_THRESH,
    PAD_ROW,
    exact_rows_sq,
    squared_norms,
)
from vector_db_tpu_torch.ops.topk import smallest_stable


def _l2_scan(queries, emb, valid, k, x_sq=None, tile=65536):
    """``l2_topk`` at any k: one launch up to 256. Past it a CUDA tensor
    takes ceil(k / 256) launches of k = 256, each after the last one's
    final (value, row) pair: the same shape every time, so a distance is
    the same bits in every pass and the passes join into the exact top-k,
    each a full read of the table. A CPU tensor takes the plain version."""
    if k <= MAX_K:
        return l2_topk(queries, emb, valid, k, x_sq=x_sq, tile=tile)
    if x_sq is None:
        x_sq = squared_norms(emb.float())
    if queries.device.type == "cpu":
        return l2_topk_plain(queries, emb, valid, k, x_sq, tile)
    return by_passes(lambda after: l2_topk(queries, emb, valid, MAX_K,
                                           x_sq=x_sq, after=after),
                     k, MAX_K)


def exact_search(
    queries: torch.Tensor,   # f32[B, d]
    emb: torch.Tensor,       # f32[N, d]
    valid: torch.Tensor,     # bool[N]
    k: int,
    x_sq: torch.Tensor | None = None,   # f32[N]; from emb when None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k by squared L2: (f32[B, k], int32[B, k]) ascending,
    (BIG, -1) padded when fewer than k rows are valid. The ``l2_topk``
    kernel runs, by passes past k = 256. A caller that
    scans one table many times passes its norms as ``x_sq``."""
    return _l2_scan(queries, emb, valid, k, x_sq=x_sq)


def exact_search_tiled(
    queries: torch.Tensor,
    emb: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    tile: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`exact_search` with the plain version streaming ``tile`` rows
    at a time (the kernel never holds more than its tile); the same passes
    past k = 256."""
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
    The ``l2_topk`` kernel runs, by passes past k = 256.
    """
    return _l2_scan(queries, emb, valid, k, x_sq=x_sq, tile=tile)


_SEL_BLOCK = 128        # block_select_search's rows per block
_RERANK_QUERIES = 128   # and queries per rerank gather


def block_select_search(
    queries: torch.Tensor,    # f32[B, dim]
    score_tab: torch.Tensor,  # f32|bf16[N, ds] phase-1 table (full or proj)
    score_q: torch.Tensor,    # f32[B, ds] queries in score space
    x_sq: torch.Tensor,       # f32[N] full-space row norms
    emb: torch.Tensor,        # f32[N, dim] exact rerank table
    valid: torch.Tensor,      # bool[N]
    k: int,
    tile: int = 131072,
    blocks_k: int = 0,
    exact_phase1: bool = False,
    approx_blocks: bool = False,
    hilo_phase1: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-phase scan: the minimum estimate of every 128 consecutive rows
    (a block), then an exact f32 rerank of every row of the best
    ``blocks_k`` blocks (default 2k), 128 queries at a time, and the final
    top-k cut (the contract of the JAX package's
    ``vector_db_tpu/ops/exact.py:block_select_search``, whose ``block`` and
    ``qblock`` no caller sets: fixed at their defaults here).

    Lossless w.r.t. phase-1 scores at blocks_k >= k: a true top-k row's
    block can be beaten only by blocks holding a closer row. Phase 1 scores
    in the table's dtype with f32 sums; ``exact_phase1`` requires those
    sums in true f32 (over an f32 table the result is then the exact
    top-k); ``hilo_phase1`` in three bf16
    products of split operands. Blocks are selected exactly, ties to the
    lower block. ``approx_blocks=True`` (the TPU's ``approx_min_k`` over
    the block minima) has no CUDA counterpart and raises.

    The corpus is scored ``tile`` rows at a time and counts as padded to a
    tile multiple (padding blocks score BIG). Returns (d_sq f32[B, k], ids
    int32[B, k]) ascending, (BIG, -1) padded.
    """
    if approx_blocks:
        raise NotImplementedError(
            "block_select_search(approx_blocks=True): approx_min_k is TPU "
            "hardware with no CUDA counterpart; selection is exact")
    block, qblock = _SEL_BLOCK, _RERANK_QUERIES
    assert tile % block == 0
    n, dim = emb.shape
    b = queries.shape[0]
    n_blocks = -(-n // tile) * tile // block
    blocks_k = min(blocks_k or 2 * k, n_blocks)
    if exact_phase1 or hilo_phase1:
        require_f32_matmul(emb)
    if hilo_phase1:
        sq_hi = score_q.to(torch.bfloat16)
        sq_lo = (score_q - sq_hi.float()).to(torch.bfloat16)
    sq = score_q.to(score_tab.dtype)

    mins = torch.full((b, n_blocks), BIG, device=emb.device)
    for s in range(0, n, tile):
        t_tab = score_tab[s:s + tile]
        if hilo_phase1:
            t_hi = t_tab.to(torch.bfloat16)
            t_lo = (t_tab.float() - t_hi.float()).to(torch.bfloat16)
            # bf16 operands multiply exactly in f32; the sums are f32
            cross = (sq_hi.float() @ t_hi.float().T
                     + sq_hi.float() @ t_lo.float().T
                     + sq_lo.float() @ t_hi.float().T)
        else:
            cross = sq.float() @ t_tab.float().T
        d = x_sq[None, s:s + tile] - 2.0 * cross
        d = torch.where(valid[None, s:s + tile], d, BIG)
        rows = d.shape[1]
        if rows % block:
            d = torch.cat([d, d.new_full((b, block - rows % block), BIG)],
                          dim=1)
        mins[:, s // block:s // block + d.shape[1] // block] = d.view(
            b, -1, block).amin(-1)
    _, bidx = smallest_stable(mins, blocks_k)        # int64[B, blocks_k]

    offs = torch.arange(block, device=emb.device)
    out_d, out_i = [], []
    for s in range(0, b, qblock):
        q_c = queries[s:s + qblock]
        ids = (bidx[s:s + qblock, :, None] * block + offs).flatten(1)
        ok = ids < n
        safe = ids.clamp(max=n - 1)
        ok &= valid[safe]
        d = exact_rows_sq(q_c, emb[safe])
        d = torch.where(ok, d.clamp_min(0.0), BIG)
        dd, pos = smallest_stable(d, k)
        ii = torch.gather(safe, 1, pos).int()
        out_d.append(dd)
        out_i.append(torch.where(dd < BIG_THRESH, ii, -1))
    return torch.cat(out_d), torch.cat(out_i)


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
