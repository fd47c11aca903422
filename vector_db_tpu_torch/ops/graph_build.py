"""Bulk graph-construction ops (port of vector_db_tpu/ops/graph_build.py).

The occlusion rule of the HNSW paper and DiskANN: a candidate c (in
ascending distance order) is dropped when an already-selected s is closer to
c than c is to the node, ``d(c, s) < alpha * d(c, q)``; pruned-out slots are
refilled with the closest rejected candidates, so rows stay at full degree.
Reverse edges, the cluster-partitioned exact kNN and NN-descent rounds
complete the bulk build.

JAX's ``lax.scan`` over chunks and clusters becomes a Python loop; every
chunk runs on the tensors' device. Exact candidates of
``build_forward_edges`` come from ``ops.exact.knn_exact``, i.e. the
``l2_topk`` kernel on CUDA. Every distance product is true f32 (raises if
CUDA matmuls may use TF32).

Ties: the JAX functions select with ``lax.top_k`` and ``lexsort``, which keep
the lower index first among equal keys. The selections here that decide
graph structure on ties (the occlusion prune's selected-first order, the
reverse merge) use stable sorts, so they resolve ties the same way. The
union-and-dedup steps (cluster merge, NN-descent) dedup by id rather than
by adjacency of bit-equal distances: two products of one pair in different
shapes may differ in the last bit on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vector_db_tpu_torch.device import require_f32_matmul
from vector_db_tpu_torch.ops.distance import BIG, l2_sq_pairwise, squared_norms
from vector_db_tpu_torch.ops.exact import knn_exact
from vector_db_tpu_torch.ops.topk import later_copies, stable_top_k_smallest


def _dedup_by_id(d: torch.Tensor, i: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row, the k best of a (distance, id) union with each id once (its
    smallest distance), ascending, (BIG, -1) padded."""
    d, pos = torch.sort(d, dim=-1, stable=True)
    i = torch.gather(i, -1, pos)
    dup = later_copies(i) & (i >= 0)   # the first copy has the smallest d
    d = torch.where(dup, BIG, d)
    i = torch.where(dup, -1, i)
    return stable_top_k_smallest(d, i, k)


def _occlusion_prune_core(cand_d, cand_i, cand_emb, deg, alpha=1.0):
    c, k = cand_d.shape
    require_f32_matmul(cand_emb)
    sq = (cand_emb * cand_emb).sum(-1)
    cross = torch.bmm(cand_emb, cand_emb.transpose(1, 2))
    pair = (sq[:, :, None] - 2.0 * cross + sq[:, None, :]).clamp_min(0.0)

    # selection scan over candidates in distance order
    sel_mask = torch.zeros((c, k), dtype=torch.bool, device=cand_d.device)
    cnt = torch.zeros((c,), dtype=torch.int32, device=cand_d.device)
    for j in range(k):
        d_j = cand_d[:, j]
        occ = (sel_mask & (pair[:, j, :] < alpha * d_j[:, None])).any(1)
        ok = (cand_i[:, j] >= 0) & (d_j < BIG) & (cnt < deg) & ~occ
        sel_mask[:, j] = ok
        cnt += ok.int()

    # selected first (in distance order), then the closest rejected; the
    # offset arithmetic is the JAX function's, rounding included
    offset = 1.0e30
    key = torch.where(sel_mask, cand_d - offset, cand_d)
    key = torch.where(cand_i >= 0, key, BIG)
    sel_key, sel_i = stable_top_k_smallest(key, cand_i, deg)
    sel_d = torch.where(sel_key < -offset / 2, sel_key + offset, sel_key)
    return sel_d, sel_i


def occlusion_prune(
    cand_d: torch.Tensor,    # f32[C, K] ascending (BIG = padding)
    cand_i: torch.Tensor,    # int32[C, K] (-1 = padding)
    cand_emb: torch.Tensor,  # f32[C, K, dim] candidate embeddings
    deg: int,
    alpha: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select up to ``deg`` diverse neighbors per node; refill to ``deg``
    with the closest rejected candidates. Returns (d f32[C, deg],
    ids int32[C, deg]), (BIG, -1) padded."""
    return _occlusion_prune_core(cand_d, cand_i, cand_emb, deg, alpha)


def build_forward_edges(
    emb: torch.Tensor,       # f32[N, dim]
    valid: torch.Tensor,     # bool[N]
    deg: int,
    k_cand: int,
    chunk: int,
    alpha: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-corpus forward-edge construction: for every valid row, its
    exact ``k_cand`` nearest valid rows (``knn_exact``, the ``l2_topk``
    kernel on CUDA), occlusion-pruned to ``deg`` edges, ``chunk`` rows at a
    time. Returns (fwd_d f32[N, deg], fwd_i int32[N, deg])."""
    n = emb.shape[0]
    out_d, out_i = [], []
    for s in range(0, n, chunk):
        q = emb[s:s + chunk]
        qi = torch.arange(s, s + q.shape[0], dtype=torch.int32,
                          device=emb.device)
        cd, ci = knn_exact(q, qi, emb, valid, k_cand)
        ce = emb[ci.clamp_min(0).long()]
        sd, si = _occlusion_prune_core(cd, ci, ce, deg, alpha)
        q_ok = valid[s:s + chunk, None]
        out_d.append(torch.where(q_ok, sd, BIG))
        out_i.append(torch.where(q_ok, si, -1))
    return torch.cat(out_d), torch.cat(out_i)


def reverse_merge(
    fwd_d: torch.Tensor,   # f32[n, deg]
    fwd_i: torch.Tensor,   # int32[n, deg] (-1 padded)
    width: int,
) -> torch.Tensor:
    """Symmetrize forward edges, dedup (v, u) pairs, keep each row's
    closest ``width``; the device twin of ``index.hnsw._reverse_merge``.

    JAX's two ``lexsort``s become stable sorts on an int64 (v, u) key and
    on w then v (torch has no lexsort; int64 does not truncate here).
    Returns rows int32[n, width] of local neighbor indices."""
    n, deg = fwd_i.shape
    dev = fwd_i.device
    src = torch.arange(n, dtype=torch.int64, device=dev).repeat_interleave(deg)
    dst = fwd_i.reshape(-1).long()
    dd = fwd_d.reshape(-1)
    ok = dst >= 0
    # undirected edge set; invalid entries get v = n (sorts last, dropped)
    v = torch.cat([torch.where(ok, src, n), torch.where(ok, dst, n)])
    u = torch.cat([torch.where(ok, dst, 0), torch.where(ok, src, 0)])
    w = torch.cat([dd, dd])

    # dedup (v, u): the first of each pair in (v, u) order survives
    order = torch.sort(v * (n + 1) + u, stable=True).indices
    v, u, w = v[order], u[order], w[order]
    dup = torch.zeros_like(ok.repeat(2))
    dup[1:] = (v[1:] == v[:-1]) & (u[1:] == u[:-1])
    v = torch.where(dup, n, v)

    # per-row closest-width: sort by (v, w), rank within each v segment
    order = torch.sort(w, stable=True).indices
    order = order[torch.sort(v[order], stable=True).indices]
    v, u = v[order], u[order]
    starts = torch.searchsorted(v, torch.arange(n, dtype=v.dtype,
                                                device=dev))
    rank = torch.arange(v.shape[0], device=dev) - starts[v.clamp(max=n - 1)]
    sel = (v < n) & (rank < width)
    rows = torch.full((n, width), -1, dtype=torch.int32, device=dev)
    rows[v[sel], rank[sel]] = u[sel].int()
    return rows


def assign_topk_clusters(
    emb: torch.Tensor,        # f32[N, dim]
    centroids: torch.Tensor,  # f32[C, dim]
    k: int,
    chunk: int = 8192,
) -> torch.Tensor:
    """Nearest-k centroid assignment, ``chunk`` rows at a time so the
    [N, C] distance matrix never exists. Returns int32[N, k]."""
    c_sq = (centroids * centroids).sum(1)
    out = [torch.topk(l2_sq_pairwise(emb[s:s + chunk], centroids, c_sq), k,
                      dim=1, largest=False).indices.int()
           for s in range(0, emb.shape[0], chunk)]
    return torch.cat(out)


def clustered_knn_merge(
    emb: torch.Tensor,      # f32[N_pad, dim]
    members: torch.Tensor,  # int32[C, Lmax] rows into emb, -1 padded
    deg: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster exact k-NN, merged across clusters into per-point
    forward edges: for each cluster, the members' [L, L] distance block,
    each member's ``deg`` nearest within the cluster, merged into the
    running [N, deg] tables (a point spilled into several clusters keeps
    the best ``deg`` of the union, each id once). A cluster is scored at
    its own size L (the JAX function pads every cluster to Lmax; the
    padding is masked there, so the result is the same). Returns
    (fwd_d f32[N_pad, deg], fwd_i int32[N_pad, deg])."""
    n_pad = emb.shape[0]
    dev = emb.device
    fwd_d = torch.full((n_pad, deg), BIG, dtype=torch.float32, device=dev)
    fwd_i = torch.full((n_pad, deg), -1, dtype=torch.int32, device=dev)
    sizes = (members >= 0).sum(1).tolist()
    for c, size in enumerate(sizes):
        if size == 0:
            continue
        m_row = members[c, :size].long()
        d = l2_sq_pairwise(emb[m_row], emb[m_row])
        # mask self and duplicate member ids
        d.masked_fill_(m_row[:, None] == m_row[None, :], BIG)
        kk = min(deg, size)
        nd, nj = torch.topk(d, kk, dim=1, largest=False, sorted=True)
        nj = torch.where(nd >= BIG, -1, m_row[nj].int())
        if kk < deg:
            nd = torch.cat([nd, nd.new_full((size, deg - kk), BIG)], 1)
            nj = torch.cat([nj, nj.new_full((size, deg - kk), -1)], 1)
        md, mi = _dedup_by_id(torch.cat([fwd_d[m_row], nd], 1),
                              torch.cat([fwd_i[m_row], nj], 1), deg)
        fwd_d[m_row] = md
        fwd_i[m_row] = mi
    return fwd_d, fwd_i


def nn_descent_round(
    emb: torch.Tensor,     # f32[N, dim]
    fwd_d: torch.Tensor,   # f32[N, deg]
    fwd_i: torch.Tensor,   # int32[N, deg]
    deg: int,
    chunk: int = 2048,
    sample: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One NN-descent refinement round: each node rescores its neighbor
    list against its neighbors' ``sample`` closest neighbors and keeps the
    best ``deg`` of the union. Candidates come from the pre-round tables
    (every node sees one snapshot). Per chunk one [chunk, deg * sample,
    dim] gather, so ``chunk`` bounds the transient (0.8 GB at chunk 1024,
    256 candidates, dim 768)."""
    require_f32_matmul(emb)
    n = emb.shape[0]
    s = min(sample if sample > 0 else deg, deg)
    k_cand = deg * s
    x_sq = squared_norms(emb)
    out_d, out_i = [], []
    for base in range(0, n, chunk):
        rows_i = fwd_i[base:base + chunk]
        rows_d = fwd_d[base:base + chunk]
        q = emb[base:base + chunk]
        c = rows_i.shape[0]
        # candidates: the neighbors' closest-s neighbor entries
        cand = fwd_i[rows_i.clamp_min(0).long()][:, :, :s].reshape(c, k_cand)
        cand = torch.where((rows_i >= 0).repeat_interleave(s, dim=1), cand,
                           -1)
        self_ids = torch.arange(base, base + c, dtype=cand.dtype,
                                device=cand.device)
        cand = torch.where(cand == self_ids[:, None], -1, cand)
        safe = cand.clamp_min(0).long()
        dot = torch.bmm(emb[safe], q[:, :, None])[..., 0]
        d = (x_sq[safe] - 2.0 * dot + (q * q).sum(-1)[:, None]).clamp_min(0.0)
        d = torch.where(cand >= 0, d, BIG)
        md, mi = _dedup_by_id(torch.cat([rows_d, d], 1),
                              torch.cat([rows_i, cand], 1), deg)
        out_d.append(md)
        out_i.append(mi)
    return torch.cat(out_d), torch.cat(out_i)


def occlusion_prune_tiled(
    emb: torch.Tensor,     # f32[N_any, dim] embedding table (gather source)
    fwd_d: torch.Tensor,   # f32[N, K] ascending candidate distances
    fwd_i: torch.Tensor,   # int32[N, K] candidate ids (-1 padded)
    deg: int,
    chunk: int = 2048,
    alpha: float = 1.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming occlusion prune over whole forward-edge tables: each chunk
    of rows gathers its [chunk, K, dim] candidates and prunes them to
    ``deg`` alpha-occlusion-selected edges with closest-rejected refill."""
    out_d, out_i = [], []
    for s in range(0, fwd_i.shape[0], chunk):
        ci = fwd_i[s:s + chunk]
        sd, si = _occlusion_prune_core(fwd_d[s:s + chunk], ci,
                                       emb[ci.clamp_min(0).long()], deg,
                                       alpha)
        out_d.append(sd)
        out_i.append(si)
    return torch.cat(out_d), torch.cat(out_i)
