"""IVF index with residual IVF-PQ and residual projection on a torch
device (port of vector_db_tpu/index/ivf.py).

Same API, validation errors, host inverted lists and npz index file as the
JAX ``IvfIndex``: ``build_index`` / ``build_arrays`` (k-means on a
subsample, tiled assignment, capacity-bounded cells, ``spill``), ``add``,
``delete``, ``search``, ``enable_pq`` (residual IVFADC, optional OPQ),
``enable_rp`` (residual projection: a PCA of the coarse residuals),
``search_batch`` in the flat, PQ and RP modes, cluster stats, and
``save_index`` / ``load_index`` (with the trained PQ and RP state).
``load_state`` adopts a JAX index's state.

On the device: the corpus table (``DeviceVectorStore``), the centroids, the
``-1``-padded ``[k, L]`` slot table, the cell-contiguous uint8 ``[k, L, m]``
PQ code blocks and the bf16 ``[k, L, dp]`` RP residual blocks. Coarse
distances are true f32 (TF32 raises), probe selection is ``torch.topk``,
and the exact rerank is elementwise f32. The JAX ``lax.map`` over query
blocks is a Python loop over blocks; the block size bounds the gathered
per-block tensors.

PQ probe scoring (``adc``): ``"pallas"`` (default), ``"onehot"`` and
``"onehot8"`` launch the ``adc_probe_scores`` CUDA kernel on a CUDA device
(the latter two are the TPU's MXU encodings of the same LUT sum; their bf16
and int8 rounding is not reproduced: the kernel sums in f32). ``"gather"``
runs the kernel's plain version. Because every formulation sums in f32,
un-reranked search needs no switch to ``"gather"`` as the JAX package makes.

At ``n_probe >= k`` both approximate modes scan every cell for the whole
batch. The PQ scan is the ``adc_topk`` kernel over the flattened cell
blocks, its residual scalars and coarse terms as the kernel's row and group
terms (the JAX package's one-hot MXU contraction computes the same LUT
sum); the RP scan is the unpadded bf16 mirror on ``l2_topk`` (weakly
clustered corpora) or the cell-block scan in plain torch. The TPU's
``approx_min_k`` becomes exact selection, ties to the lower position
(:func:`ops.topk.smallest_stable`). bf16 operands are multiplied in f32
(exact products), summed in f32. Each full scan answers at every
``fetch`` on every device: its kernel runs in one launch up to its lists
(2048 for the PQ scan's ``adc_topk``, 256 for the flat RP route's
``l2_topk``) and by passes past them, each from where the last one's list
ended (``ops.cuda.by_passes``; ``ops.exact`` for the l2 scans).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vector_db_tpu_torch.device import require_f32_matmul, resolve_device
from vector_db_tpu_torch.index.pq import (
    PQCodec,
    _adc_lut,
    _encode_residual_scan,
    _encode_scan,
)
from vector_db_tpu_torch.ops.cuda import by_passes
from vector_db_tpu_torch.ops.cuda.adc_probe import (
    adc_probe_plain,
    adc_probe_scores,
)
from vector_db_tpu_torch.ops.cuda.adc_scan import (
    MAX_K as ADC_MAX_K,
    adc_topk,
    adc_topk_plain,
)
from vector_db_tpu_torch.ops.distance import (
    BIG,
    BIG_THRESH,
    gather_l2_sq,
    l2_sq_pairwise,
    squared_norms,
)
from vector_db_tpu_torch.ops.exact import approx_search_tiled, rescore_exact
from vector_db_tpu_torch.ops.kmeans import assign_tiled, kmeans
from vector_db_tpu_torch.ops.topk import (
    later_copies,
    masked_top_k_smallest,
    smallest_stable,
)
from vector_db_tpu_torch.storage import InMemoryNodeStorage, NodeStorage
from vector_db_tpu_torch.storage.device_store import DeviceVectorStore
from vector_db_tpu_torch.types import Node

ADC_MODES = ("pallas", "onehot", "onehot8", "gather")
_PANEL = 1 << 26   # bound (elements) on a query block's gathered tensors
_CELL_CHUNK = 256   # cells per pass of the RP block rebuild


def _top_k(d: torch.Tensor, ids: torch.Tensor, k: int):
    """masked_top_k_smallest over the last axis, BIG-padded first when
    there are fewer than k entries."""
    if d.shape[-1] < k:
        pad = k - d.shape[-1]
        d = torch.cat([d, d.new_full(d.shape[:-1] + (pad,), BIG)], -1)
        ids = torch.cat([ids, ids.new_full(ids.shape[:-1] + (pad,), -1)], -1)
    return masked_top_k_smallest(d, ids, k)


def _probe(queries, centroids, n_probe):
    """(coarse distances f32[B, k] in true f32, probed cells [B, n_probe])."""
    cd = l2_sq_pairwise(queries, centroids)
    return cd, torch.topk(cd, n_probe, dim=1, largest=False).indices


def _ivf_search_batch(
    centroids: torch.Tensor,   # f32[k, d]
    lists: torch.Tensor,       # int32[k, L], -1 padded (slots)
    emb: torch.Tensor,         # f32[capacity, d]
    has_emb: torch.Tensor,     # bool[capacity]
    queries: torch.Tensor,     # f32[B, d]
    fmask: Optional[torch.Tensor],  # bool[capacity] or None
    n_probe: int,
    top_k: int,
    dedup: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat IVF: exact f32 distances to every member of the probed cells."""
    _, probe = _probe(queries, centroids, n_probe)
    p_total = n_probe * lists.shape[1]
    qblock = max(1, _PANEL // (p_total * emb.shape[1]))
    out_d, out_i = [], []
    for s in range(0, queries.shape[0], qblock):
        pb = probe[s:s + qblock]
        members = lists[pb].reshape(pb.shape[0], -1)       # [qb, P]
        safe = members.clamp_min(0).long()
        ok = has_emb[safe]
        if fmask is not None:
            ok = ok & fmask[safe]
        d = gather_l2_sq(queries[s:s + qblock], emb, members, ok)
        if not dedup:
            td, ti = _top_k(d, members, top_k)
        else:
            # spilled copies of one slot carry identical distances: take a
            # 2k window, drop repeats pairwise (small), then cut to k
            td, ti = _top_k(d, members, min(2 * top_k, p_total))
            rep = (ti[:, :, None] == ti[:, None, :]) & (ti[:, :, None] >= 0)
            drop = torch.tril(rep, diagonal=-1).any(-1)
            td, ti = _top_k(torch.where(drop, BIG, td),
                            torch.where(drop, -1, ti), top_k)
        out_d.append(td)
        out_i.append(ti)
    return torch.cat(out_d), torch.cat(out_i)


def _ivf_pq_probe_cells(
    centroids: torch.Tensor,    # f32[k, d]
    cell_slots: torch.Tensor,   # int32[k, L] slot ids, -1 padded
    cell_codes: torch.Tensor,   # uint8[k, L, m] PQ codes, cell-contiguous
    cell_s: torch.Tensor,       # f32[k, L] residual correction scalars
    codebooks: torch.Tensor,    # f32[m, ksub, subdim]
    emb: torch.Tensor,          # f32[capacity, d] (exact rerank source)
    has_emb: torch.Tensor,      # bool[capacity]
    queries: torch.Tensor,      # f32[B, d]
    queries_rot: torch.Tensor,  # f32[B, d] in code space (OPQ)
    n_probe: int,
    top_k: int,
    fetch: int,
    rerank: bool,
    residual: bool,
    qblock: int = 64,
    adc: str = "pallas",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVFADC probe over cell-contiguous code blocks: gather the probed
    cells' codes, score them by ADC (with the residual correction
    ``cell_s + ||q - c||^2 - ||q_rot||^2``), keep the top ``fetch``, rerank
    those exactly in f32, cut the top k (or return the ADC top k when
    un-reranked)."""
    m = codebooks.shape[0]
    L = cell_slots.shape[1]
    fetch = max(top_k, min(fetch, n_probe * L))
    cd, probe = _probe(queries, centroids, n_probe)
    lut = _adc_lut(queries_rot, codebooks)                  # [B, m, ksub]
    if residual:
        # the LUT sum carries ||q_rot||^2; rotation keeps norms
        q_sq = (queries_rot * queries_rot).sum(-1)
        cdp = torch.gather(cd, 1, probe) - q_sq[:, None]
    score = adc_probe_plain if adc == "gather" else adc_probe_scores
    out_d, out_i = [], []
    for s in range(0, queries.shape[0], qblock):
        pb = probe[s:s + qblock]
        qb = pb.shape[0]
        slots = cell_slots[pb].reshape(qb, -1)              # [qb, P]
        codes = cell_codes[pb].reshape(qb, -1, m)           # [qb, P, m]
        if residual:
            corr = (cell_s[pb].reshape(qb, -1)
                    + cdp[s:s + qb].repeat_interleave(L, dim=1))
        else:
            corr = torch.zeros(slots.shape, dtype=torch.float32,
                               device=slots.device)
        ok = (slots >= 0) & has_emb[slots.clamp_min(0).long()]
        d = score(lut[s:s + qb], codes, corr, ok)
        if not rerank:
            td, ti = _top_k(d, slots, top_k)
        else:
            fd, fi = _top_k(d, slots, fetch)
            fd = gather_l2_sq(queries[s:s + qb], emb, fi, fi >= 0)
            td, ti = masked_top_k_smallest(fd, fi, top_k)
        out_d.append(td)
        out_i.append(ti)
    return torch.cat(out_d), torch.cat(out_i)


def _f32_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in true f32 (raises where TF32 could enter). bf16 operands
    widen first: their products are exact in f32, as the JAX package's
    bf16 x bf16 -> f32 contractions."""
    require_f32_matmul(a)
    return a.float() @ b.float()


def _rerank(queries, emb, sv, top_k, dedup):
    """The exact-rerank tail of the RP/PQ scans: (optionally) void the later
    copies of a slot among each row's candidate slots ``sv``, rescore
    exactly in f32, cut the top k."""
    if dedup:
        sv = torch.where(later_copies(sv) & (sv >= 0), -1, sv)
    fd = gather_l2_sq(queries, emb, sv, sv >= 0)
    return masked_top_k_smallest(fd, sv, top_k)


def _ivf_rp_probe_cells(
    centroids: torch.Tensor,   # f32[k, d]
    mu_proj: torch.Tensor,     # f32[dp] projected global data mean
    cell_slots: torch.Tensor,  # int32[k, L] slot ids, -1 padded
    cell_rp: torch.Tensor,     # bf16[k, L, dp] projected residuals
    cell_xsq: torch.Tensor,    # f32[k, L] stored scalars
    emb: torch.Tensor,         # f32[capacity, d] (exact rerank source)
    has_emb: torch.Tensor,     # bool[capacity]
    queries: torch.Tensor,     # f32[B, d]
    proj: torch.Tensor,        # f32[d, dp] orthonormal projection
    n_probe: int,
    top_k: int,
    fetch: int,
    rerank: bool,
    dedup: bool,
    qblock: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual-projection probe: each probed cell's [L, dp] residual block
    scored against the mu-centred projected query,

        d(q, x) ~ (||q - c||^2 - ||c||^2) - 2 (q^ - mu^) . r^ + t,

    the top ``fetch`` reranked exactly (or the estimates' top k returned
    un-reranked). The block product widens bf16 to f32 (exact products, f32
    sums). Queries run ``qblock`` at a time and probes one after another, so
    a step holds one [qblock, L, dp] block."""
    b = queries.shape[0]
    max_l = cell_slots.shape[1]
    p_total = n_probe * max_l
    fetch = max(top_k, min(fetch, p_total))
    cd, probe = _probe(queries, centroids, n_probe)
    qp = _f32_dot(queries, proj)
    csq = squared_norms(centroids)[probe]
    corr = torch.gather(cd, 1, probe) - csq                 # [B, n_probe]
    qr = (qp - mu_proj[None, :]).to(torch.bfloat16).float()
    out_d, out_i = [], []
    for s in range(0, b, qblock):
        pb, cb, qb = probe[s:s + qblock], corr[s:s + qblock], qr[s:s + qblock]
        nq = pb.shape[0]
        scores = torch.empty((nq, n_probe, max_l), device=queries.device)
        slots = cell_slots[pb]                              # [nq, n_probe, L]
        for pi in range(n_probe):
            cells = pb[:, pi].long()
            dots = torch.bmm(cell_rp[cells].float(), qb[:, :, None])[..., 0]
            score = cb[:, pi, None] - 2.0 * dots + cell_xsq[cells]
            sl = slots[:, pi]
            ok = (sl >= 0) & has_emb[sl.clamp_min(0).long()]
            scores[:, pi] = torch.where(ok, score, BIG)
        d_all = scores.reshape(nq, p_total)
        s_all = slots.reshape(nq, p_total)
        if p_total < fetch:  # tiny-corpus guard
            pad = fetch - p_total
            d_all = torch.cat([d_all, d_all.new_full((nq, pad), BIG)], 1)
            s_all = torch.cat([s_all, s_all.new_full((nq, pad), -1)], 1)
        if not rerank:
            td, ti = masked_top_k_smallest(d_all, s_all, top_k)
        else:
            nd, pos = smallest_stable(d_all, fetch)
            fi = torch.where(nd >= BIG_THRESH, -1, torch.gather(s_all, 1, pos))
            td, ti = _rerank(queries[s:s + qblock], emb, fi, top_k, dedup)
        out_d.append(td)
        out_i.append(ti)
    return torch.cat(out_d), torch.cat(out_i)


def _ivf_rp_scan_cells(
    centroids: torch.Tensor,   # f32[k, d]
    cell_slots: torch.Tensor,  # int32[k, L] slot ids, -1 padded
    cell_rp: torch.Tensor,     # bf16[k, L, dp] residual blocks
    cell_t: torch.Tensor,      # f32[k, L] stored scalars
    emb: torch.Tensor,         # f32[capacity, d] (exact rerank source)
    has_emb: torch.Tensor,     # bool[capacity]
    queries: torch.Tensor,     # f32[B, d]
    proj: torch.Tensor,        # f32[d, dp]
    mu_proj: torch.Tensor,     # f32[dp]
    top_k: int,
    fetch: int,
    rerank: bool,
    dedup: bool,
    ctile: int = 64,
    qblock: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-scan residual projection: every cell for the whole batch, one
    tile of ``ctile`` cells at a time (one f32 product of the widened
    [ctile * L, dp] block against ``qblock`` queries),

        score[b, c, l] = (||q||^2 - 2 q.c) - 2 (q^ - mu^) . r^[c, l] + t,

    keeping per tile the best ``min(max(top_k, fetch // min(4, tiles)),
    ctile * L)`` (the JAX package's per-tile cap, which makes the
    candidate set depend on ``ctile``) merged into a running top-``fetch``,
    then the exact rerank."""
    b = queries.shape[0]
    k_cells, max_l = cell_slots.shape
    dp = cell_rp.shape[-1]
    assert k_cells % ctile == 0, "k_cells must be a multiple of ctile"
    p_tile = ctile * max_l
    n_tiles = k_cells // ctile
    fetch = max(top_k, min(fetch, k_cells * max_l))
    per_tile = min(max(top_k, fetch // min(4, n_tiles)), p_tile)
    corr = (squared_norms(queries)[:, None]
            - 2.0 * _f32_dot(queries, centroids.T))           # [B, k]
    qp = (_f32_dot(queries, proj) - mu_proj[None, :]).to(
        torch.bfloat16).float()
    slot_ok = (cell_slots >= 0) & has_emb[cell_slots.clamp_min(0).long()]
    best_d = torch.full((b, fetch), BIG, device=queries.device)
    best_i = torch.full((b, fetch), -1, dtype=torch.int32,
                        device=queries.device)
    for ti in range(n_tiles):
        c0 = ti * ctile
        blk = cell_rp[c0:c0 + ctile].reshape(p_tile, dp).float()
        t = cell_t[c0:c0 + ctile].reshape(p_tile)
        slots = cell_slots[c0:c0 + ctile].reshape(p_tile)
        ok = slot_ok[c0:c0 + ctile].reshape(p_tile)
        for s in range(0, b, qblock):
            dots = _f32_dot(qp[s:s + qblock], blk.T)          # [nq, p_tile]
            score = (corr[s:s + qblock, c0:c0 + ctile].repeat_interleave(
                max_l, dim=1) - 2.0 * dots) + t[None]
            score = torch.where(ok[None], score, BIG)
            nd, pos = smallest_stable(score, per_tile)
            si = torch.where(nd >= BIG_THRESH, -1, slots[pos])
            cat_d = torch.cat([best_d[s:s + qblock], nd], 1)
            cat_i = torch.cat([best_i[s:s + qblock], si], 1)
            md, mpos = smallest_stable(cat_d, fetch)
            best_d[s:s + qblock] = md
            best_i[s:s + qblock] = torch.where(
                md >= BIG, -1, torch.gather(cat_i, 1, mpos))
    if not rerank:
        return best_d[:, :top_k], best_i[:, :top_k]
    return _rerank(queries, emb, best_i, top_k, dedup)


def _ivf_pq_scan_cells(
    centroids: torch.Tensor,    # f32[k, d]
    cell_slots: torch.Tensor,   # int32[k, L] slot ids, -1 padded
    cell_codes: torch.Tensor,   # uint8[k, L, m] PQ codes, cell-contiguous
    cell_s: torch.Tensor,       # f32[k, L] residual correction scalars
    codebooks: torch.Tensor,    # f32[m, ksub, subdim]
    emb: torch.Tensor,          # f32[capacity, d] (exact rerank source)
    has_emb: torch.Tensor,      # bool[capacity]
    queries: torch.Tensor,      # f32[B, d]
    queries_rot: torch.Tensor,  # f32[B, d] in code space (OPQ)
    top_k: int,
    fetch: int,
    rerank: bool,
    residual: bool,
    dedup: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-scan ADC over every cell for the whole batch: the ``adc_topk``
    kernel over the cell blocks flattened to [k * L, m] rows, each row's
    residual scalar as its row term and ``||q - c||^2 - ||q_rot||^2`` as the
    (query, cell) group term of the cell's L rows; one exact top-``fetch``
    (the JAX package keeps ``min(fetch, tile)`` a tile, which is the same
    set), mapped back through the slot table, then the exact rerank.
    ``fetch`` past the kernel's lists (2048) takes passes of it on a CUDA
    tensor, the plain version on a CPU one (``adc_topk_long``'s rule)."""
    k_cells, max_l, m = cell_codes.shape
    fetch = max(top_k, min(fetch, k_cells * max_l))
    lut = _adc_lut(queries_rot, codebooks)                  # [B, m, ksub]
    corr = None
    if residual:
        cd = l2_sq_pairwise(queries, centroids)
        corr = cd - (queries_rot * queries_rot).sum(-1)[:, None]   # [B, k]
    slots = cell_slots.reshape(-1)
    valid = (slots >= 0) & has_emb[slots.clamp_min(0).long()]
    codes = cell_codes.reshape(-1, m)
    kw = dict(row_bias=cell_s.reshape(-1) if residual else None,
              group_bias=corr, group=max_l)
    if fetch <= ADC_MAX_K:
        fd, pos = adc_topk(lut, codes, valid, fetch, **kw)
    elif lut.device.type == "cpu":
        fd, pos = adc_topk_plain(lut, codes, valid, fetch, **kw)
    else:
        fd, pos = by_passes(lambda after: adc_topk(
            lut, codes, valid, ADC_MAX_K, after=after, **kw), fetch,
            ADC_MAX_K)
    fi = torch.where(pos >= 0, slots[pos.clamp_min(0).long()], -1)
    if not rerank:
        return fd[:, :top_k], fi[:, :top_k]
    return _rerank(queries, emb, fi, top_k, dedup)


def _rp_flat_search(
    queries: torch.Tensor,   # f32[B, d]
    proj: torch.Tensor,      # f32[d, dp]
    mu: torch.Tensor,        # f32[dp]
    flat: torch.Tensor,      # bf16[capacity, dp] centred mirror
    u: torch.Tensor,         # f32[capacity] stored scalars
    valid: torch.Tensor,     # bool[capacity]
    emb: torch.Tensor,       # f32[capacity, d] (exact rerank source)
    top_k: int,
    fetch: int,
    rerank: bool,
    tile: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat projected scan: the centred mirror through
    ``ops.exact.approx_search_tiled`` (the ``l2_topk`` kernel over a bf16
    table) with ``u`` as its norms, then the exact rerank; un-reranked, the
    estimates plus the per-query constant. ``fetch`` past the kernel's
    lists (256) takes passes of it, as every l2 scan does."""
    qp = _f32_dot(queries, proj)
    fd, fi = approx_search_tiled(qp - mu[None, :], flat, valid, fetch,
                                 tile=tile, x_sq=u)
    if rerank:
        d_sq, slots = rescore_exact(queries, emb, fi)
        return d_sq[:, :top_k], slots[:, :top_k]
    off = (squared_norms(queries) - squared_norms(qp)
           + (mu * mu).sum())
    return fd[:, :top_k] + off[:, None], fi[:, :top_k]


def _build_rp_blocks(
    table: torch.Tensor,      # int32[k, L] slot ids, -1 padded
    rp: torch.Tensor,         # f32[capacity, dp] per-slot x^
    xsq: torch.Tensor,        # f32[capacity] full-space ||x||^2
    cent_proj: torch.Tensor,  # f32[k, dp]
    mu_proj: torch.Tensor,    # f32[dp]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RP cell blocks: residuals r^ = x^ - c^ (bf16 only after the
    subtraction) and stored scalars t = ||x||^2 - 2 mu^ . r^, zero on
    padding slots; ``_CELL_CHUNK`` cells at a time."""
    k_cells, max_l = table.shape
    dp = rp.shape[1]
    res16 = torch.empty((k_cells, max_l, dp), dtype=torch.bfloat16,
                        device=rp.device)
    t = torch.empty((k_cells, max_l), device=rp.device)
    for c in range(0, k_cells, _CELL_CHUNK):
        tab = table[c:c + _CELL_CHUNK]
        safe = tab.clamp_min(0).long()
        ok = tab >= 0
        res = rp[safe] - cent_proj[c:c + _CELL_CHUNK, None, :]
        res = torch.where(ok[..., None], res, 0.0)
        tc = xsq[safe] - 2.0 * _f32_dot(res, mu_proj[:, None])[..., 0]
        t[c:c + _CELL_CHUNK] = torch.where(ok, tc, 0.0)
        res16[c:c + _CELL_CHUNK] = res.to(torch.bfloat16)
    return res16, t


class IvfIndex:
    def __init__(
        self,
        k: int,
        storage: Optional[NodeStorage] = None,
        index_file: Optional[Union[str, Path]] = None,
        device="cuda",
    ) -> None:
        if k <= 0:
            raise ValueError("k-means parameter should be positive")
        self.k = int(k)
        self.device = resolve_device(device)
        self.storage = storage or InMemoryNodeStorage()
        self.index_file = Path(index_file) if index_file else None

        self.centroids: Optional[np.ndarray] = None
        self._centroids_dev: Optional[torch.Tensor] = None
        # host inverted lists of node ids (parity + persistence)
        self.inverted_lists: List[List[int]] = []
        # device: padded slot table and PQ code blocks, rebuilt when dirty
        self._lists_dev: Optional[torch.Tensor] = None
        self._lists_dirty = True
        self._cells_codes_dev: Optional[torch.Tensor] = None
        self._cells_s_dev: Optional[torch.Tensor] = None
        # persist index_file on every mutation (reference behavior);
        # services set False and flush on their threshold
        self.autosave = True
        self._spill = 1
        self._pq: Optional[PQCodec] = None
        self._pq_residual = False
        self._codes_np: Optional[np.ndarray] = None  # uint8[capacity, m]
        self._sx_np: Optional[np.ndarray] = None     # f32[capacity]
        # residual projection (enable_rp): the PCA projection, the per-slot
        # x^ = x @ proj and ||x||^2, the cell blocks built from them, and the
        # flat scan's centred mirror (None until first used after a change)
        self._rp_proj: Optional[np.ndarray] = None   # f32[dim, dp]
        self._rp_proj_dev: Optional[torch.Tensor] = None
        self._rp_dev: Optional[torch.Tensor] = None  # f32[capacity, dp]
        self._rp_xsq_dev: Optional[torch.Tensor] = None
        self._rp_mu_dev: Optional[torch.Tensor] = None
        self._cent_proj_dev: Optional[torch.Tensor] = None
        self._cells_rp_dev: Optional[torch.Tensor] = None
        self._cells_xsq_dev: Optional[torch.Tensor] = None
        self._rp_flat = None    # (centred bf16 mirror, u)
        self._rp_res_ratio = 1.0

        self._store = DeviceVectorStore(capacity=256, device=self.device)

        if self.index_file and self.index_file.exists():
            self.load_index()

    # device tables live in DeviceVectorStore
    @property
    def _emb(self):
        return self._store.emb

    @property
    def _has_emb(self):
        return self._store.valid

    @property
    def _capacity(self) -> int:
        return self._store.capacity

    @property
    def _dim(self):
        return self._store.dim

    @property
    def _slot_of_id(self):
        return self._store._slot_of_id

    # ------------------------------------------------------------------
    def _ensure_capacity(self, need: int, dim: int) -> None:
        self._store.ensure_dim(dim)
        self._store.grow_to(need)

    def _set_centroids(self, cents: np.ndarray) -> None:
        self.centroids = np.array(cents, np.float32)
        self._centroids_dev = torch.tensor(self.centroids, device=self.device)

    def _slot_table(self) -> np.ndarray:
        """Vectorized [k, max_list] -1-padded slot table from the host
        inverted lists (no per-member Python loop; O(total) numpy)."""
        sizes = np.asarray([len(l) for l in self.inverted_lists], np.int64)
        total = int(sizes.sum())
        max_list = max(int(sizes.max()) if sizes.size else 0, 1)
        table = np.full((self.k, max_list), -1, np.int32)
        if total:
            flat_ids = np.fromiter(
                (nid for lst in self.inverted_lists for nid in lst),
                np.int64, count=total,
            )
            slot_map = self._slot_of_id
            flat_slots = np.fromiter(
                (slot_map.get(int(nid), -1) for nid in flat_ids),
                np.int32, count=total,
            )
            rows = np.repeat(np.arange(self.k), sizes)
            offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            cols = np.arange(total) - offsets[rows]
            table[rows, cols] = flat_slots
        return table

    def _rebuild_device_tables(self) -> None:
        table = self._slot_table()
        self._lists_dev = torch.from_numpy(table).to(self.device)
        codes_np = self._ensure_codes_capacity()
        if codes_np is not None:
            safe = np.maximum(table, 0)
            blocks = codes_np[safe]                  # [k, L, m] uint8
            blocks[table < 0] = 0
            self._cells_codes_dev = torch.from_numpy(blocks).to(self.device)
            if self._sx_np is not None:
                s_blocks = self._sx_np[safe].astype(np.float32)
                s_blocks[table < 0] = 0.0
                self._cells_s_dev = torch.from_numpy(s_blocks).to(
                    self.device)
            else:
                self._cells_s_dev = torch.zeros(
                    table.shape, dtype=torch.float32, device=self.device)
        else:
            self._cells_codes_dev = None
            self._cells_s_dev = None
        if self._rp_dev is not None:
            self._cells_rp_dev, self._cells_xsq_dev = _build_rp_blocks(
                self._lists_dev, self._rp_dev, self._rp_xsq_dev,
                self._cent_proj_dev, self._rp_mu_dev)
        else:
            self._cells_rp_dev = self._cells_xsq_dev = None
        self._lists_dirty = False

    def _ensure_codes_capacity(self) -> Optional[np.ndarray]:
        """Grow the host PQ code table to match store capacity (new rows
        zero-coded until written)."""
        codes_np = self._codes_np
        if codes_np is not None and codes_np.shape[0] < self._capacity:
            grow = self._capacity - codes_np.shape[0]
            codes_np = np.concatenate([
                codes_np, np.zeros((grow, codes_np.shape[1]), np.uint8),
            ])
            self._codes_np = codes_np
            if self._sx_np is not None:
                self._sx_np = np.concatenate(
                    [self._sx_np, np.zeros((grow,), np.float32)]
                )
        return codes_np

    def _ensure_rp_capacity(self) -> None:
        """Grow the per-slot RP rows with the store (new rows zero)."""
        rp = self._rp_dev
        if rp is not None and rp.shape[0] < self._capacity:
            grow = self._capacity - rp.shape[0]
            self._rp_dev = torch.cat([rp, rp.new_zeros((grow, rp.shape[1]))])
            self._rp_xsq_dev = torch.cat(
                [self._rp_xsq_dev, self._rp_xsq_dev.new_zeros((grow,))])

    def _rp_flat_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The flat scan's mirror: ((x^ - mu^) bf16[capacity, dp],
        u = ||x||^2 - 2 mu^ . x^ f32[capacity]), rebuilt after the RP rows
        change (``add``, ``enable_rp``, a load). Ranking identity:
        ||q - x||^2 ~ ||q^ - mu^||^2 - 2 (q^ - mu^).(x^ - mu^) + u + const(q),
        so ``approx_search_tiled`` runs it with u as the norms."""
        if self._rp_flat is None:
            mu = self._rp_mu_dev
            self._rp_flat = (
                (self._rp_dev - mu[None, :]).to(torch.bfloat16),
                self._rp_xsq_dev - 2.0 * _f32_dot(self._rp_dev,
                                                  mu[:, None])[:, 0])
        return self._rp_flat

    def _set_rp(self, proj: np.ndarray, mu: np.ndarray) -> None:
        """Install a projection and the projected mean, and project the
        table: x^ (f32) and the full-space ||x||^2 per slot."""
        self._rp_proj = np.array(proj, np.float32)
        self._rp_proj_dev = torch.from_numpy(self._rp_proj).to(self.device)
        self._cent_proj_dev = torch.from_numpy(
            self.centroids @ self._rp_proj).to(self.device)
        self._rp_mu_dev = torch.from_numpy(np.array(mu, np.float32)).to(
            self.device)
        self._rp_dev = _f32_dot(self._emb, self._rp_proj_dev)
        self._rp_xsq_dev = squared_norms(self._emb)
        self._rp_flat = None
        self._lists_dirty = True    # the RP cell blocks rebuild

    def _device_lists(self) -> torch.Tensor:
        if self._lists_dirty or self._lists_dev is None:
            self._rebuild_device_tables()
        return self._lists_dev

    def _device_cells(self):
        if self._lists_dirty or self._cells_codes_dev is None:
            self._rebuild_device_tables()
        return self._lists_dev, self._cells_codes_dev, self._cells_s_dev

    # ------------------------------------------------------------------
    def build_index(self, nodes: Sequence[Node], seed: int = 0) -> None:
        if not nodes:
            raise ValueError("Cannot build index with empty node list")
        for node in nodes:
            self.storage.save(node)

        embeddings = np.array(
            [np.asarray(n.embedding, np.float32) for n in nodes])
        ids = [n.id for n in nodes]
        if embeddings.ndim != 2:
            raise ValueError(
                f"embeddings must be 2D array, got {embeddings.ndim}D"
            )
        if embeddings.shape[0] < self.k:
            raise ValueError(
                f"Need at least {self.k} vectors for {self.k} clusters"
            )

        self._ensure_capacity(len(nodes), embeddings.shape[1])
        slots = np.array(
            [self._store.slot_of(nid) if nid in self._store
             else self._store.take_slot(nid) for nid in ids],
            np.int32,
        )
        self._store.write(slots, embeddings)

        cents, labels = kmeans(
            torch.from_numpy(embeddings).to(self.device), self.k,
            torch.Generator().manual_seed(seed), iters=100,
        )
        self._set_centroids(cents.cpu().numpy())
        labels = labels.cpu().numpy()

        self.inverted_lists = [[] for _ in range(self.k)]
        for nid, label in zip(ids, labels):
            self.inverted_lists[int(label)].append(nid)
        self._lists_dirty = True

        if self.index_file:
            self.save_index()

    def build_arrays(
        self,
        ids: Sequence[int],
        embeddings: np.ndarray,
        seed: int = 0,
        iters: int = 25,
        train_sample: Optional[int] = None,
        assign_candidates: int = 8,
        list_cap_alpha: float = 4.0,
        spill: int = 1,
    ) -> None:
        """Scale-path build (no Node objects): train k-means on a subsample
        (default ``min(N, max(64k, 100k))`` rows), assign the full corpus
        in one tiled device pass, construct the inverted lists vectorized.

        ``list_cap_alpha`` bounds cell size at ``alpha * N / k``: members of
        an over-full cell cascade to their next-nearest centroid (up to
        ``assign_candidates`` choices). ``spill`` > 1 multi-assigns each
        vector to its ``spill`` nearest distinct cells (SOAR-style
        spilling); search de-duplicates repeated slots in the top-k window.
        """
        embeddings = np.asarray(embeddings, np.float32)
        ids_arr = np.asarray(list(ids), np.int64)
        n, dim = embeddings.shape
        if n != ids_arr.shape[0]:
            raise ValueError("ids and embeddings must have equal length")
        if n < self.k:
            raise ValueError(
                f"Need at least {self.k} vectors for {self.k} clusters"
            )
        self._ensure_capacity(n, dim)
        slots = self._store.take_slots(ids_arr.tolist())
        self._store.write(slots, embeddings)

        sample = train_sample or min(n, max(64 * self.k, 100_000))
        rng = np.random.default_rng(seed)
        sel = (rng.choice(n, size=sample, replace=False)
               if sample < n else np.arange(n))
        cents, _ = kmeans(
            torch.from_numpy(embeddings[sel]).to(self.device), self.k,
            torch.Generator().manual_seed(seed), iters=iters,
        )
        self._set_centroids(cents.cpu().numpy())

        spill = max(1, min(int(spill), self.k))
        n_cand = max(spill, min(assign_candidates, self.k))
        tile = 65536 if n >= 65536 else max(256, 1 << (n - 1).bit_length())
        cand = assign_tiled(torch.from_numpy(embeddings), cents, tile=tile,
                            n_cand=n_cand).cpu().numpy()
        labels = self._balanced_assign(cand, list_cap_alpha)
        all_ids, all_labels = [ids_arr], [labels]
        taken = labels[:, None]                     # cells already used
        # spill copies respect a widened cap so the padded [k, L] probe
        # tensor stays O(alpha * spill * N/k); over-cap copies are dropped
        # (those rows stay single-assigned)
        cap2 = max(1, int(np.ceil(list_cap_alpha * spill * n / self.k)))
        counts = np.bincount(labels, minlength=self.k)
        for _ in range(1, spill):
            sec = np.full(n, -1, np.int64)
            for j in range(n_cand):
                todo = sec < 0
                cj = cand[:, j].astype(np.int64)
                fresh = todo & ~(taken == cj[:, None]).any(axis=1)
                sec[fresh] = cj[fresh]
            want_rows = np.flatnonzero(sec >= 0)
            w = sec[want_rows]
            order2 = np.argsort(w, kind="stable")
            sw = w[order2]
            group_start = np.searchsorted(sw, np.arange(self.k))
            rank = np.arange(want_rows.size) - group_start[sw]
            accept = rank < (cap2 - counts[sw])
            keep = want_rows[order2[accept]]
            sec_final = np.full(n, -1, np.int64)
            sec_final[keep] = sec[keep]
            counts += np.bincount(sec_final[keep], minlength=self.k)
            ok = sec_final >= 0
            all_ids.append(ids_arr[ok])
            all_labels.append(sec_final[ok])
            taken = np.concatenate([taken, sec_final[:, None]], axis=1)
        ids_cat = np.concatenate(all_ids)
        lab_cat = np.concatenate(all_labels)
        self._spill = spill

        order = np.argsort(lab_cat, kind="stable")
        sorted_ids = ids_cat[order]
        bounds = np.searchsorted(lab_cat[order], np.arange(self.k + 1))
        self.inverted_lists = [
            sorted_ids[bounds[c]:bounds[c + 1]].tolist()
            for c in range(self.k)
        ]
        self._lists_dirty = True
        if self.index_file and self.autosave:
            self.save_index()

    def _balanced_assign(
        self, cand: np.ndarray, alpha: float
    ) -> np.ndarray:
        """Capacity-bounded nearest-centroid assignment (host numpy, as the
        JAX package's). cand: int32[N, C] per-row nearest centroids, best
        first. Each row takes its best candidate whose cell is under
        ``cap = alpha * N / k``; stragglers take relaxed (doubling) caps."""
        n, n_cand = cand.shape
        cap = max(1, int(np.ceil(alpha * n / self.k)))
        chosen = np.full(n, -1, np.int64)
        counts = np.zeros(self.k, np.int64)

        def accept_rounds(limit: int) -> None:
            nonlocal counts
            for c in range(n_cand):
                todo = np.flatnonzero(chosen < 0)
                if todo.size == 0:
                    return
                want = cand[todo, c].astype(np.int64)
                order = np.argsort(want, kind="stable")
                sw = want[order]
                # rank of each row within its cluster group this round
                group_start = np.searchsorted(sw, np.arange(self.k))
                rank = np.arange(todo.size) - group_start[sw]
                accept = rank < (limit - counts[sw])
                taken = order[accept]
                chosen[todo[taken]] = sw[accept]
                counts += np.bincount(sw[accept], minlength=self.k)

        limit = cap
        while (chosen < 0).any() and limit < 2 * n:
            accept_rounds(limit)
            limit *= 2
        left = np.flatnonzero(chosen < 0)
        if left.size:  # keep the total = n invariant
            chosen[left] = cand[left, 0]
        return chosen

    def load_state(
        self,
        emb: np.ndarray,
        valid: np.ndarray,
        id_of_slot: np.ndarray,
        centroids: np.ndarray,
        inverted_lists: Sequence[Sequence[int]],
        codebooks: Optional[np.ndarray] = None,
        rotation: Optional[np.ndarray] = None,
        residual: bool = False,
        codes: Optional[np.ndarray] = None,
        sx: Optional[np.ndarray] = None,
        spill: int = 1,
        rp_proj: Optional[np.ndarray] = None,
        rp_mu: Optional[np.ndarray] = None,
        rp_res_ratio: float = 1.0,
    ) -> None:
        """Adopt another index's state given as numpy arrays, e.g. a JAX
        ``IvfIndex``'s: the table, valid mask and id map
        (``np.asarray(idx._store.emb)``, ``np.asarray(idx._store.valid)``,
        ``idx._store.export_id_map()``), ``centroids``, ``inverted_lists``,
        and with PQ enabled the ``codebooks``, OPQ ``rotation``, residual
        flag, codes ``_codes_np`` and residual scalars ``_sx_np``; ``spill``
        is ``_spill``. Without ``codes`` the table is re-encoded. With RP
        enabled: ``rp_proj`` (``_rp_proj``), ``rp_mu``
        (``np.asarray(_rp_mu_dev)``) and ``_rp_res_ratio``; the projected
        rows are recomputed from the table."""
        self._store = DeviceVectorStore.from_arrays(
            emb, valid, id_of_slot, device=self.device)
        self._set_centroids(centroids)
        self.k = self.centroids.shape[0]
        self.inverted_lists = [[int(i) for i in lst] for lst in inverted_lists]
        if len(self.inverted_lists) != self.k:
            raise ValueError(f"load_state: {len(self.inverted_lists)} "
                             f"inverted lists for {self.k} centroids")
        self._spill = int(spill)
        self._lists_dirty = True
        self._pq = None
        self._codes_np = self._sx_np = None
        self._rp_proj = self._rp_proj_dev = self._rp_dev = None
        self._rp_flat = None
        if rp_proj is not None:
            self._set_rp(rp_proj, rp_mu)
            self._rp_res_ratio = float(rp_res_ratio)
        if codebooks is None:
            return
        self._pq = PQCodec.from_arrays(codebooks, rotation,
                                       device=self.device)
        if codes is None:
            self._reencode_pq(bool(residual))
            return
        self._pq_residual = bool(residual)
        self._codes_np = np.array(codes, np.uint8)
        self._sx_np = None if sx is None else np.array(sx, np.float32)

    def add(self, node: Node) -> None:
        if self.centroids is None:
            raise ValueError("Index must be built before adding nodes")
        embedding = np.asarray(node.embedding, np.float32)
        if embedding.ndim != 1:
            raise ValueError("embedding must be 1D array")
        if embedding.shape[0] != self.centroids.shape[1]:
            raise ValueError(
                f"embedding dimension {embedding.shape[0]} doesn't match "
                f"centroid dimension {self.centroids.shape[1]}"
            )
        self.storage.save(node)
        self._store.ensure_dim(embedding.shape[0])
        slot = self._store.slot_of(node.id)
        if slot is None:
            slot = self._store.take_slot(node.id)
        self._store.write(np.asarray([slot], np.int32), embedding[None, :])

        distances = np.linalg.norm(self.centroids - embedding, axis=1)
        nearest = int(np.argmin(distances))
        for c in np.argsort(distances)[:max(1, self._spill)]:
            self.inverted_lists[int(c)].append(node.id)
        if self._rp_dev is not None:
            self._ensure_rp_capacity()
            row = torch.from_numpy(embedding).to(self.device)
            self._rp_dev[slot] = _f32_dot(row[None, :], self._rp_proj_dev)[0]
            self._rp_xsq_dev[slot] = (row * row).sum()
            self._rp_flat = None
        if self._ensure_codes_capacity() is not None:
            # keep the PQ code row current so the cell rebuild stays valid
            vec = embedding[None, :]
            if self._pq_residual:
                vec = vec - self.centroids[nearest][None, :]
            code = self._pq.encode(vec)
            self._codes_np[slot] = code[0]
            if self._sx_np is not None:
                # s = 2 c_rot . recon_rot = 2 c . recon_orig (rotation cancels)
                self._sx_np[slot] = 2.0 * float(
                    np.dot(self.centroids[nearest],
                           self._pq.decode(code)[0])
                )
        self._lists_dirty = True
        if self.index_file and self.autosave:
            self.save_index()

    def delete(self, node_id: int) -> None:
        for cluster_list in self.inverted_lists:
            if node_id in cluster_list:
                cluster_list.remove(node_id)
        self._store.release(node_id)
        self._lists_dirty = True
        if hasattr(self.storage, "delete"):
            self.storage.delete(node_id)
        if self.index_file and self.autosave:
            self.save_index()

    # ------------------------------------------------------------------
    def _validate_query(self, query: np.ndarray, n_probe: int) -> None:
        if self.centroids is None:
            raise ValueError("Index must be built before searching")
        if query.ndim != 1:
            raise ValueError("query must be 1D array")
        if query.shape[0] != self.centroids.shape[1]:
            raise ValueError(
                f"query dimension {query.shape[0]} doesn't match "
                f"centroid dimension {self.centroids.shape[1]}"
            )
        if n_probe <= 0 or n_probe > self.k:
            raise ValueError(f"n_probe must be between 1 and {self.k}")

    def search(
        self, query: np.ndarray, n_probe: int, top_k: int
    ) -> List[Tuple[Node, float]]:
        query = np.asarray(query, np.float32)
        self._validate_query(query, n_probe)
        dists, ids = self.search_batch(query[None, :], n_probe, top_k)
        out: List[Tuple[Node, float]] = []
        for nid, d in zip(ids[0], dists[0]):
            if nid < 0:
                continue
            node = self.storage.get(int(nid))
            if node is not None:
                out.append((node, float(d)))
        return out

    def _slot_cell_table(self) -> np.ndarray:
        """int32[capacity] coarse cell of each live slot (-1 for dead);
        one vectorized pass over the padded slot table."""
        out = np.full(self._capacity, -1, np.int32)
        table = self._slot_table()
        valid = table >= 0
        cells = np.broadcast_to(
            np.arange(self.k, dtype=np.int32)[:, None], table.shape
        )
        out[table[valid]] = cells[valid]
        return out

    def enable_pq(self, chunks: int = 16, ksub: int = 256, seed: int = 0,
                  restarts: int = 2, opq_iters: int = 0,
                  train_sample: int = 262144, residual: bool = True) -> None:
        """Attach IVF-PQ scoring: train codebooks on the stored vectors and
        encode them; ``search_batch(..., pq=True)`` then scores probed
        candidates by asymmetric PQ distance with exact rerank.
        ``opq_iters`` > 0 trains an OPQ rotation first (``PQCodec.train``).

        ``residual=True`` (default) trains and encodes the residuals
        ``x - c_cell(x)``, the IVFADC formulation (Jegou et al.); the
        per-cell term folds into one stored scalar per row."""
        if self.centroids is None:
            raise ValueError("Index must be built before enabling PQ")
        if residual and self._spill > 1:
            raise ValueError(
                "residual PQ stores one code per slot and cannot serve "
                "spilled (multi-assigned) copies; use enable_rp() for "
                "spilled indexes, or enable_pq(residual=False)"
            )
        live = self._has_emb.cpu().numpy()
        n_live = int(live.sum())
        ksub = min(ksub, max(2, n_live))
        if ksub > 256:
            raise ValueError("ksub must be <= 256 (codes are uint8)")
        self._pq = PQCodec(k=ksub, chunks=chunks, dim=self._dim,
                           device=self.device)
        slot_cell = self._slot_cell_table() if residual else None
        if residual:
            live = live & (slot_cell >= 0)
        train_rows = np.flatnonzero(live)
        if train_rows.shape[0] > train_sample:
            train_rows = np.random.default_rng(seed).choice(
                train_rows, train_sample, replace=False
            )
        train = self._emb[torch.from_numpy(train_rows).to(
            self.device)].cpu().numpy()
        if residual:
            train = train - self.centroids[slot_cell[train_rows]]
        self._pq.train(train, seed=seed, restarts=restarts,
                       opq_iters=opq_iters)
        self._reencode_pq(residual, slot_cell)

    def enable_rp(self, dims: int = 128, seed: int = 0,
                  train_sample: int = 131072) -> None:
        """Attach residual-projection scoring: PCA of the coarse residuals
        ``x - c_cell`` (a covariance of up to ``train_sample`` live rows)
        down to ``dims`` directions; the projected table x^ = x @ R stays
        f32 per slot, with the full-space ||x||^2, and the cell blocks keep
        the bf16 residuals r^ = x^ - c^. x^ does not depend on the cell, so
        spilled copies share it (``build_arrays(spill > 1)`` works, unlike
        residual PQ). ``_rp_res_ratio`` (residual over deviation energy of
        the sample) picks the full-scan route in ``search_batch``."""
        if self.centroids is None:
            raise ValueError("Index must be built before enabling RP")
        dims = int(min(dims, self._dim))
        if dims <= 0:
            raise ValueError("dims must be positive")
        slot_cell = self._slot_cell_table()
        live = self._has_emb.cpu().numpy() & (slot_cell >= 0)
        rows = np.flatnonzero(live)
        if rows.size == 0:
            raise ValueError("no live vectors to train the projection")
        if rows.shape[0] > train_sample:
            rows = np.random.default_rng(seed).choice(
                rows, train_sample, replace=False)
        rows_dev = torch.from_numpy(rows).to(self.device)
        sample = self._emb[rows_dev]
        res = sample - self._centroids_dev[
            torch.from_numpy(slot_cell[rows]).to(self.device).long()]
        cov = _f32_dot(res.T, res).cpu().numpy() / max(1, rows.shape[0])
        _, v = np.linalg.eigh(cov.astype(np.float64))
        proj = v[:, ::-1][:, :dims].astype(np.float32)       # [dim, dims]
        mean = sample.mean(0)
        mu = _f32_dot(mean[None, :], torch.from_numpy(proj).to(
            self.device))[0]
        self._set_rp(proj, mu.cpu().numpy())
        # cell-vs-flat heuristic: how much of the deviation energy the
        # coarse centroids absorb (strongly clustered corpora keep the
        # padded cell-block scan, weakly clustered ones the flat mirror)
        res_e = float((res * res).sum(-1).mean())
        dev = sample - mean
        dev_e = float((dev * dev).sum(-1).mean())
        self._rp_res_ratio = res_e / max(dev_e, 1e-30)

    def search_batch(
        self, queries: np.ndarray, n_probe: int, top_k: int,
        pq: bool = False, rp: bool = False, rerank: bool = True,
        filter_ids=None, fetch: Optional[int] = None,
        adc: str = "pallas",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(L2 f32[B, top_k], ids int64[B, top_k]), (inf, -1) padded.
        ``filter_ids`` folds into the validity mask of every mode. ``pq``
        scores probes by (residual) ADC and reranks the top ``fetch``
        (default ``max(4 * top_k, 100)``) exactly; ``adc`` picks the ADC
        formulation (module docstring)."""
        if self.centroids is None:
            raise ValueError("Index must be built before searching")
        q = torch.from_numpy(
            np.ascontiguousarray(queries, np.float32)).to(self.device)
        fmask = None
        if filter_ids is not None:
            fmask = torch.from_numpy(
                self._store.filter_mask(filter_ids)).to(self.device)
        if fetch is None:
            fetch = max(4 * int(top_k), 100)
        spilled = self._spill > 1
        has = self._has_emb if fmask is None else self._has_emb & fmask
        if rp:
            d_sq, slots = self._search_rp(q, has, int(n_probe), int(top_k),
                                          int(fetch), rerank, spilled)
        elif pq and int(n_probe) >= self.k:
            if self._pq is None:
                raise ValueError("call enable_pq() first")
            cell_slots, cell_codes, cell_s = self._device_cells()
            d_sq, slots = _ivf_pq_scan_cells(
                self._centroids_dev, cell_slots, cell_codes, cell_s,
                self._pq.codebooks, self._emb, has, q,
                self._pq.rotate_queries(queries), top_k=int(top_k),
                fetch=int(fetch), rerank=rerank,
                residual=self._pq_residual, dedup=spilled)
        elif pq:
            if self._pq is None:
                raise ValueError("call enable_pq() first")
            if adc not in ADC_MODES:
                raise ValueError(f"Unknown adc mode: {adc}")
            cell_slots, cell_codes, cell_s = self._device_cells()
            # the largest per-block transient is the plain version's
            # gathered f32 LUT values, qblock * P * m
            p_tot = int(n_probe) * cell_slots.shape[1]
            qblock = 64
            while qblock > 4 and qblock * p_tot * self._pq.chunks * 4 > \
                    268_435_456:
                qblock //= 2
            d_sq, slots = _ivf_pq_probe_cells(
                self._centroids_dev, cell_slots, cell_codes, cell_s,
                self._pq.codebooks, self._emb, has, q,
                self._pq.rotate_queries(queries),
                n_probe=int(n_probe), top_k=int(top_k), fetch=int(fetch),
                rerank=rerank, residual=self._pq_residual, qblock=qblock,
                adc=adc,
            )
        else:
            d_sq, slots = _ivf_search_batch(
                self._centroids_dev, self._device_lists(), self._emb,
                self._has_emb, q, fmask, n_probe=int(n_probe),
                top_k=int(top_k), dedup=spilled,
            )
        d_sq = d_sq.cpu().numpy()
        slots = slots.cpu().numpy()
        ids = self._store.ids_of(slots)
        dists = np.where(slots >= 0, np.sqrt(np.maximum(d_sq, 0.0)), np.inf)
        return dists.astype(np.float32), ids

    def _search_rp(self, q, has, n_probe, top_k, fetch, rerank, spilled):
        """The three RP routes, chosen as the JAX package chooses: the flat
        mirror at n_probe >= k on a weakly clustered corpus (residual ratio
        above 0.5), else the cell-block scan at n_probe >= k, else the
        probe."""
        if self._rp_dev is None:
            raise ValueError("call enable_rp() first")
        if self._lists_dirty or self._cells_rp_dev is None:
            self._rebuild_device_tables()
        if n_probe >= self.k and self._rp_res_ratio > 0.5:
            flat, u = self._rp_flat_tables()
            return _rp_flat_search(
                q, self._rp_proj_dev, self._rp_mu_dev, flat, u, has,
                self._emb, top_k=top_k, fetch=fetch, rerank=rerank,
                tile=min(flat.shape[0], 131072))
        if n_probe >= self.k:
            # few, big steps: grow ctile until a tile is ~128k slots, and
            # bound the [qblock, tile] score at ~256 MB
            max_l = self._lists_dev.shape[1]
            ctile = math.gcd(self.k, 64)
            for cand in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
                if self.k % cand == 0 and cand * max_l <= 131072:
                    ctile = cand
                    break
            qblock = 1 << (max(1, min(q.shape[0], 512)) - 1).bit_length()
            while qblock > 8 and qblock * ctile * max_l * 4 > 268_435_456:
                qblock //= 2
            return _ivf_rp_scan_cells(
                self._centroids_dev, self._lists_dev, self._cells_rp_dev,
                self._cells_xsq_dev, self._emb, has, q, self._rp_proj_dev,
                self._rp_mu_dev, top_k=top_k, fetch=fetch, rerank=rerank,
                dedup=spilled, ctile=ctile, qblock=qblock)
        return _ivf_rp_probe_cells(
            self._centroids_dev, self._rp_mu_dev, self._lists_dev,
            self._cells_rp_dev, self._cells_xsq_dev, self._emb, has, q,
            self._rp_proj_dev, n_probe=n_probe, top_k=top_k, fetch=fetch,
            rerank=rerank, dedup=spilled)

    @property
    def size(self) -> int:
        """Live vector count (sum of inverted-list sizes)."""
        return sum(len(lst) for lst in self.inverted_lists)

    # ------------------------------------------------------------------
    def get_cluster_size(self, cluster_id: int) -> int:
        if cluster_id < 0 or cluster_id >= self.k:
            raise ValueError(f"cluster_id must be between 0 and {self.k - 1}")
        return len(self.inverted_lists[cluster_id])

    def get_cluster_stats(self) -> dict:
        sizes = [len(lst) for lst in self.inverted_lists]
        return {
            "min_size": min(sizes) if sizes else 0,
            "max_size": max(sizes) if sizes else 0,
            "avg_size": sum(sizes) / len(sizes) if sizes else 0,
            "total_vectors": sum(sizes),
        }

    # ------------------------------------------------------------------
    def save_index(self) -> None:
        """The JAX package's npz: centroids, lists, and the trained PQ and
        RP state (codes and projected rows regenerate from the table at
        load)."""
        if self.index_file is None or self.centroids is None:
            return
        self.index_file.parent.mkdir(parents=True, exist_ok=True)
        extra = {}
        if self._rp_proj is not None:
            extra["rp_proj"] = self._rp_proj
            extra["rp_mu"] = self._rp_mu_dev.cpu().numpy()
        if self._pq is not None and self._pq.codebooks is not None:
            extra["pq_codebooks"] = self._pq.codebooks.cpu().numpy()
            extra["pq_residual"] = np.asarray(self._pq_residual)
            if self._pq.rotation is not None:
                extra["pq_rotation"] = self._pq.rotation.cpu().numpy()
        if self._spill > 1:
            extra["spill"] = np.asarray(self._spill)
        np.savez(
            self.index_file,
            k=self.k,
            centroids=self.centroids,
            list_ids=np.concatenate(
                [np.asarray(l, np.int64) for l in self.inverted_lists]
            ) if any(self.inverted_lists) else np.zeros((0,), np.int64),
            list_sizes=np.asarray(
                [len(l) for l in self.inverted_lists], np.int64
            ),
            **extra,
        )

    def load_index(self) -> None:
        if self.index_file is None or not self.index_file.exists():
            return
        with np.load(self.index_file) as z:
            self.k = int(z["k"])
            centroids = np.asarray(z["centroids"])
            sizes = np.asarray(z["list_sizes"])
            flat = np.asarray(z["list_ids"])
            aux = {name: np.asarray(z[name]) for name in
                   ("rp_proj", "rp_mu", "pq_codebooks", "pq_rotation",
                    "pq_residual", "spill") if name in z}
        self._set_centroids(centroids)
        self.inverted_lists = []
        off = 0
        for s in sizes:
            self.inverted_lists.append([int(x) for x in flat[off:off + s]])
            off += int(s)
        self._lists_dirty = True
        if "spill" in aux:
            self._spill = int(aux["spill"])
        # hydrate embeddings from storage in one bulk read (spilled ids
        # appear in several lists; dedupe preserving first occurrence)
        all_ids = list(dict.fromkeys(
            nid for lst in self.inverted_lists for nid in lst))
        if all_ids:
            self._ensure_capacity(len(all_ids), self.centroids.shape[1])
            rows, found = self.storage.get_embeddings(all_ids)
            if found.any():
                slots = np.asarray([
                    self._store.slot_of(nid)
                    if nid in self._store else self._store.take_slot(nid)
                    for nid, f in zip(all_ids, found) if f
                ], np.int32)
                self._store.write(slots, rows[found])
        if "rp_proj" in aux and all_ids:
            self._set_rp(aux["rp_proj"], aux["rp_mu"])
            self._rp_res_ratio = 1.0    # not saved: the cell-block scan
        if "pq_codebooks" in aux and all_ids:
            self._pq = PQCodec.from_arrays(
                aux["pq_codebooks"], aux.get("pq_rotation"),
                device=self.device)
            self._reencode_pq(residual=bool(aux.get("pq_residual", False)))

    def _reencode_pq(self, residual: bool,
                     slot_cell: Optional[np.ndarray] = None) -> None:
        """Encode the whole table with the codec's codebooks (dead rows
        too: harmless, masked at probe), ``chunk`` rows at a time."""
        rot = self._pq.rotation
        chunk = min(8192, self._capacity)
        if residual:
            if slot_cell is None:
                slot_cell = self._slot_cell_table()
            cent_rot = self._centroids_dev
            if rot is not None:
                require_f32_matmul(cent_rot)
                cent_rot = cent_rot @ rot
            codes, sx = _encode_residual_scan(
                self._emb, torch.from_numpy(np.maximum(slot_cell, 0)),
                cent_rot, self._pq.codebooks, chunk=chunk, rotation=rot,
            )
            self._sx_np = sx.cpu().numpy().astype(np.float32)
        else:
            codes = _encode_scan(self._emb, self._pq.codebooks, chunk=chunk,
                                 rotation=rot)
            self._sx_np = None
        self._pq_residual = bool(residual)
        self._codes_np = codes.cpu().numpy().astype(np.uint8)
        self._lists_dirty = True
