"""HNSW graph tables, the classic best-first search and the streaming
insert, batched (port of vector_db_tpu/index/hnsw_kernels.py).

The graph is one ``int32[capacity, NCOLS]`` neighbor table, -1 padded:
level-0 edges occupy columns [0, 2M), level-l >= 1 edges [M(l+1), M(l+2)).
Search is a best-first beam: each step pops the nearest unexpanded
candidate(s), gathers their neighbor rows, scores the unvisited neighbors
with exact f32 distances, and merges them into an ef-wide pool. The PQ
and projected (RP) searches run the same beam under another score: an ADC
LUT sum over the node's codes, or a bf16 PCA mirror's dot; their ef
candidates are reranked exactly.

JAX ``vmap``s a ``while_loop`` per query. Here the queries run together as
one batched loop over [B, ...] tensors: each query carries its own
``active`` flag, a query whose loop condition fails keeps its state (every
update is a ``torch.where`` on it), and the loop ends when no query is
active or at ``max_steps``. The visited set is a [B, capacity/32] int32
bitmap; newly visited ids are unique per step (deduplicated when E > 1 rows
are expanded), so ``scatter_add_`` of their bits is a bitwise or.

A streaming insert is two steps per batch: candidates for every new point
against the pre-batch graph (``construction_candidates_exact``, an exact
masked scan on the ``l2_topk`` kernel; or ``construction_search``, the
per-point beam), then the edge commit (``commit_inserts_grouped``, or the
item-at-a-time ``commit_inserts``). The commit is exact bookkeeping: on the
same inputs it gives the JAX package's table bit for bit. Its selections
are stable sorts, so ties keep ``lax.top_k``'s order (lower position
first), and the scatters JAX drops out of bounds (``mode="drop"``) are
filtered out before they are written.

Graph tensors are updated in place (``delete_slot``, the commits): a
1M-row table is 0.45 GB, and a copy per mutation would double it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from vector_db_tpu_torch.ops.distance import (
    BIG,
    BIG_THRESH,
    gather_l2_sq,
    l2_sq_pairwise,
    squared_norms,
)
from vector_db_tpu_torch.ops.exact import exact_search
from vector_db_tpu_torch.ops.topk import (
    later_copies,
    masked_top_k_smallest,
    stable_top_k_smallest,
)


@dataclass
class Graph:
    """HNSW graph state, on one device.

    neighbors:   int32[capacity, NCOLS], -1-padded adjacency rows per level.
    levels:      int32[capacity], a node's top level; -1 = not in the graph.
    entry:       the entry point slot; -1 = empty graph.
    entry_level: the entry point's level (-1 = empty).
    """

    neighbors: torch.Tensor
    levels: torch.Tensor
    entry: int
    entry_level: int


def ncols(M: int, l_max: int) -> int:
    # level 0: 2M cols at [0, 2M); level l>=1: M cols at [M(l+1), M(l+2)).
    # One extra M of -1 padding at the tail lets upper-level reads use a
    # 2M-wide slice regardless of level.
    return M * (l_max + 2)


def level_col_start(level: int, M: int) -> int:
    """Column offset of level ``level``'s adjacency slice."""
    return 0 if level == 0 else M * (level + 1)


def level_width(level: int, M: int) -> int:
    """m_limit per level: 2M at level 0, M above."""
    return 2 * M if level == 0 else M


def empty_graph(capacity: int, M: int, l_max: int, device) -> Graph:
    return Graph(
        neighbors=torch.full((capacity, ncols(M, l_max)), -1,
                             dtype=torch.int32, device=device),
        levels=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        entry=-1,
        entry_level=-1,
    )


def _dist_to(queries: torch.Tensor, emb: torch.Tensor, idx: torch.Tensor,
             has_emb: torch.Tensor) -> torch.Tensor:
    """Traversal scoring: true f32 squared L2 of each query [B, d] to its
    own gathered rows ``emb[idx]`` (idx [B, K], -1 padded), BIG where the
    row is missing. The table may be a bf16 mirror (rows widen to f32)."""
    return gather_l2_sq(queries, emb, idx, has_emb[idx.clamp_min(0).long()])


def greedy_descent(
    graph: Graph,
    score: Callable[[torch.Tensor], torch.Tensor],
    start_slot: torch.Tensor,   # int32[B]
    start_d: torch.Tensor,      # f32[B]
    stop_level: torch.Tensor,   # int32[B] or a scalar
    M: int,
    l_max: int,
    max_moves: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-best hill climb from the top level down to ``stop_level``
    (levels below it are left alone), batched: at each level every query
    moves to its best neighbor while that improves, at most ``max_moves``
    times. ``score(idx int32[B, K]) -> f32[B, K]`` is each query's
    distance oracle (BIG where invalid). Returns (slot int32[B],
    distance f32[B])."""
    cur, cur_d = start_slot.clone(), start_d.clone()
    stop_level = torch.as_tensor(stop_level, device=cur.device)
    for level in range(l_max - 1, 0, -1):
        if level > graph.entry_level:
            continue
        start = M * (level + 1)
        moving = (level >= stop_level).expand(cur.shape).clone()
        for _ in range(max_moves):
            if not bool(moving.any()):
                break
            nbr = graph.neighbors[cur.clamp_min(0).long(), start:start + M]
            d = score(nbr)
            j = torch.argmin(d, dim=1, keepdim=True)   # first minimum
            dj = torch.gather(d, 1, j)[:, 0]
            better = moving & (dj < cur_d)
            cur = torch.where(better, torch.gather(nbr, 1, j)[:, 0], cur)
            cur_d = torch.where(better, dj, cur_d)
            moving = better
    return cur, cur_d


def _visited_init(entry_slot: torch.Tensor, capacity: int) -> torch.Tensor:
    words = (capacity + 31) // 32
    b = entry_slot.shape[0]
    visited = torch.zeros((b, words), dtype=torch.int32,
                          device=entry_slot.device)
    safe = entry_slot.clamp_min(0).long()
    bit = torch.where(entry_slot >= 0,
                      torch.ones_like(entry_slot) << (safe & 31).int(), 0)
    visited.scatter_(1, (safe >> 5)[:, None], bit[:, None])
    return visited


def _expand(graph: Graph, curs: torch.Tensor, visited: torch.Tensor,
            level: int, M: int, expand: int, live: torch.Tensor):
    """Neighbors of the popped slots ``curs`` [B, E] at ``level`` and which
    of them are fresh (unvisited, first occurrence); marks the fresh ones
    visited for the queries in ``live``. Returns (nbr int32[B, E*2M],
    fresh bool[B, E*2M])."""
    start = level_col_start(level, M)
    width = level_width(level, M)
    b = curs.shape[0]
    rows = graph.neighbors[curs.clamp_min(0).long(), start:start + 2 * M]
    col_ok = torch.arange(2 * M, device=curs.device) < width
    nbr = torch.where(col_ok & (curs[:, :, None] >= 0), rows, -1).reshape(b, -1)
    safe = nbr.clamp_min(0).long()
    bits = (torch.gather(visited, 1, safe >> 5) >> (safe & 31)) & 1
    fresh = (nbr >= 0) & (bits == 0)
    if expand > 1:
        # the same neighbor may sit in several gathered rows: keep the first
        # so no bit is added twice
        fresh = fresh & ~later_copies(nbr)
    mark = fresh & live[:, None]
    wordv = torch.where(mark, torch.ones_like(nbr) << (safe & 31).int(), 0)
    visited.scatter_add_(1, torch.where(mark, safe >> 5, 0), wordv)
    return nbr, fresh


def _pop(pool_d: torch.Tensor, pool_s: torch.Tensor, expand: int):
    """The E nearest entries of ``pool_d`` (BIG = expanded or empty):
    (slots int32[B, E], -1 where nothing is left; positions int64[B, E])."""
    if expand == 1:
        pos = torch.argmin(pool_d, dim=1, keepdim=True)
    else:
        pos = torch.topk(pool_d, expand, dim=1, largest=False).indices
    ok = torch.gather(pool_d, 1, pos) < BIG_THRESH
    return torch.where(ok, torch.gather(pool_s, 1, pos), -1), pos


def beam_layer(
    graph: Graph,
    score: Callable[[torch.Tensor], torch.Tensor],
    capacity: int,
    res_ok: Callable[[torch.Tensor], torch.Tensor],
    entry_slot: torch.Tensor,   # int32[B]
    entry_d: torch.Tensor,      # f32[B]
    active: torch.Tensor,       # bool[B]
    res_mask: Optional[torch.Tensor],   # bool[capacity] or None
    level: int,
    ef: int,
    M: int,
    max_steps: int,
    pool: int = 0,
    expand: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pool best-first search of width ``ef`` at ``level``: a
    candidate frontier of ``max(pool, ef)`` entries and an ef-wide result
    pool that only ``res_mask``-matching, storage-present nodes enter
    (filtered nodes still navigate). ``expand`` pops E candidates per step.
    Stops per query when its nearest unexpanded candidate is farther than
    its worst result. Returns (res_d f32[B, ef], res_s int32[B, ef]),
    BIG/-1 padded, unsorted."""
    b = entry_slot.shape[0]
    dev = entry_slot.device
    pool = max(pool, ef)
    expand = max(1, min(expand, pool))

    cand_d = torch.full((b, pool), BIG, dtype=torch.float32, device=dev)
    cand_s = torch.full((b, pool), -1, dtype=torch.int32, device=dev)
    cand_d[:, 0] = entry_d
    cand_s[:, 0] = entry_slot

    entry_ok = res_ok(entry_slot[:, None])[:, 0] & (entry_slot >= 0)
    if res_mask is not None:
        entry_ok = entry_ok & res_mask[entry_slot.clamp_min(0).long()]
    res_d = torch.full((b, ef), BIG, dtype=torch.float32, device=dev)
    res_s = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    res_d[:, 0] = torch.where(entry_ok, entry_d, BIG)
    res_s[:, 0] = torch.where(entry_ok, entry_slot, -1)
    visited = _visited_init(entry_slot, capacity)

    for _ in range(max_steps):
        best = cand_d.min(1).values
        worst = res_d.max(1).values
        go = active & (best < BIG_THRESH) & ~(best > worst)
        if not bool(go.any()):
            break
        curs, pos = _pop(cand_d, cand_s, expand)
        popped = cand_d.scatter(1, pos, BIG)
        nbr, fresh = _expand(graph, curs, visited, level, M, expand, go)
        d = score(torch.where(fresh, nbr, -1))
        md, ms = masked_top_k_smallest(torch.cat([popped, d], 1),
                                       torch.cat([cand_s, nbr], 1), pool)
        d_res = d
        if res_mask is not None:
            d_res = torch.where(res_mask[nbr.clamp_min(0).long()], d, BIG)
        rd, rs = masked_top_k_smallest(torch.cat([res_d, d_res], 1),
                                       torch.cat([res_s, nbr], 1), ef)
        g = go[:, None]
        cand_d = torch.where(g, md, cand_d)
        cand_s = torch.where(g, ms, cand_s)
        res_d = torch.where(g, rd, res_d)
        res_s = torch.where(g, rs, res_s)
    return res_d, res_s


def beam_layer_unified(
    graph: Graph,
    score: Callable[[torch.Tensor], torch.Tensor],
    capacity: int,
    entry_slot: torch.Tensor,   # int32[B]
    entry_d: torch.Tensor,      # f32[B]
    active: torch.Tensor,       # bool[B]
    level: int,
    ef: int,
    M: int,
    max_steps: int,
    expand: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-pool best-first search for unfiltered queries (the hnswlib
    formulation): one ef-wide pool of the best visited nodes with
    per-entry expanded flags, one top-k merge per step. Returns
    (res_d f32[B, ef], res_s int32[B, ef]), BIG/-1 padded, unsorted."""
    b = entry_slot.shape[0]
    dev = entry_slot.device
    expand = max(1, min(expand, ef))

    pool_d = torch.full((b, ef), BIG, dtype=torch.float32, device=dev)
    pool_s = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    pool_e = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    pool_d[:, 0] = entry_d
    pool_s[:, 0] = entry_slot
    visited = _visited_init(entry_slot, capacity)

    for _ in range(max_steps):
        unexp = torch.where(pool_e, BIG, pool_d)
        best = unexp.min(1).values
        worst = pool_d.max(1).values
        go = active & (best < BIG_THRESH) & ~(best > worst)
        if not bool(go.any()):
            break
        curs, pos = _pop(unexp, pool_s, expand)
        expanded = pool_e.scatter(1, pos, True)
        nbr, fresh = _expand(graph, curs, visited, level, M, expand, go)
        d = score(torch.where(fresh, nbr, -1))
        cat_d = torch.cat([pool_d, d], 1)
        cat_s = torch.cat([pool_s, nbr], 1)
        cat_e = torch.cat([expanded, torch.zeros_like(fresh)], 1)
        nd, idx = torch.topk(cat_d, ef, dim=1, largest=False, sorted=True)
        ns = torch.where(nd < BIG_THRESH, torch.gather(cat_s, 1, idx), -1)
        ne = torch.gather(cat_e, 1, idx)
        g = go[:, None]
        pool_d = torch.where(g, nd, pool_d)
        pool_s = torch.where(g, ns, pool_s)
        pool_e = torch.where(g, ne, pool_e)
    return pool_d, torch.where(pool_d < BIG_THRESH, pool_s, -1)


def _descend(graph: Graph, score, b: int, dev, M: int, l_max: int):
    """Every query's greedy descent from the entry point to level 1 under
    ``score``: (slot int32[B], distance f32[B], active bool[B], False on
    an empty graph)."""
    entry = torch.full((b,), graph.entry, dtype=torch.int32, device=dev)
    entry_d = score(entry[:, None])[:, 0]
    cur, cur_d = greedy_descent(graph, score, entry, entry_d, 1, M, l_max)
    active = torch.full((b,), graph.entry >= 0, dtype=torch.bool, device=dev)
    return cur, cur_d, active


def search_batch(
    graph: Graph,
    emb: torch.Tensor,          # f32|bf16[capacity, d] traversal table
    has_emb: torch.Tensor,      # bool[capacity]
    queries: torch.Tensor,      # f32[B, d]
    filter_mask: Optional[torch.Tensor],
    M: int,
    l_max: int,
    ef: int,
    k: int,
    max_steps: int,
    use_filter: bool,
    pool: int = 0,
    expand: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched HNSW search: greedy descent from the entry point through the
    upper levels, then the level-0 beam (two pools under a filter).
    Returns (dists_sq f32[B, k], slots int32[B, k]) ascending, (BIG, -1)
    padded."""
    capacity = emb.shape[0]
    rm = filter_mask if use_filter else None

    def score(idx):
        return _dist_to(queries, emb, idx, has_emb)

    def res_ok(idx):
        return has_emb[idx.clamp_min(0).long()]

    cur, cur_d, active = _descend(graph, score, queries.shape[0],
                                  queries.device, M, l_max)
    if rm is None:
        rd, rs = beam_layer_unified(graph, score, capacity, cur, cur_d, active,
                                    level=0, ef=ef, M=M, max_steps=max_steps,
                                    expand=expand)
    else:
        rd, rs = beam_layer(graph, score, capacity, res_ok, cur, cur_d, active,
                            res_mask=rm, level=0, ef=ef, M=M,
                            max_steps=max_steps, pool=pool, expand=expand)
    return masked_top_k_smallest(rd, rs, k)


def _beam_search_scored(graph: Graph, score, capacity: int, b: int, dev,
                        M: int, l_max: int, ef: int, max_steps: int,
                        expand: int):
    """Greedy descent and the level-0 beam under ``score`` (the unfiltered
    route of :func:`search_batch`): the ef-wide pool (d, slots)."""
    cur, cur_d, active = _descend(graph, score, b, dev, M, l_max)
    return beam_layer_unified(graph, score, capacity, cur, cur_d, active,
                              level=0, ef=ef, M=M, max_steps=max_steps,
                              expand=expand)


def search_batch_pq(
    graph: Graph,
    codes: torch.Tensor,        # int32|uint8[capacity, m] PQ codes
    codebooks: torch.Tensor,    # f32[m, ksub, subdim]
    emb: torch.Tensor,          # f32[capacity, d] (exact rerank only)
    has_emb: torch.Tensor,      # bool[capacity]
    queries: torch.Tensor,      # f32[B, d]
    queries_rot: torch.Tensor,  # f32[B, d] in code space (OPQ)
    M: int,
    l_max: int,
    ef: int,
    k: int,
    max_steps: int,
    expand: int = 1,
    rerank: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HNSW-over-PQ search: the beam scores a node by its asymmetric PQ
    distance, a row of m codes looked up in the query's LUT (an f32 sum)
    instead of a d-wide row. With ``rerank`` the ef candidates are rescored
    exactly in f32 before the top-k cut; without it the ADC estimates are
    returned. Returns (d_sq f32[B, k], slots int32[B, k])."""
    from vector_db_tpu_torch.index.pq import _adc_lut

    b = queries.shape[0]
    m, ksub = codebooks.shape[:2]
    lut = _adc_lut(queries_rot, codebooks).reshape(b, m * ksub)
    offs = torch.arange(m, device=lut.device) * ksub

    def score(idx):
        safe = idx.clamp_min(0).long()
        c = codes[safe].long() + offs                      # [B, K, m]
        d = torch.gather(lut, 1, c.reshape(b, -1)).reshape(c.shape).sum(-1)
        return torch.where((idx >= 0) & has_emb[safe], d, BIG)

    rd, rs = _beam_search_scored(graph, score, emb.shape[0], b,
                                 queries.device, M, l_max, ef, max_steps,
                                 expand)
    if rerank:
        rd = gather_l2_sq(queries, emb, rs, has_emb[rs.clamp_min(0).long()])
    return masked_top_k_smallest(rd, rs, k)


def search_batch_rp(
    graph: Graph,
    rp: torch.Tensor,           # bf16[capacity, dp] PCA-projected mirror
    xsq: torch.Tensor,          # f32[capacity] full-space ||x||^2
    emb: torch.Tensor,          # f32[capacity, d] (exact rerank only)
    has_emb: torch.Tensor,      # bool[capacity]
    queries: torch.Tensor,      # f32[B, d]
    queries_proj: torch.Tensor,  # f32[B, dp] projected queries
    M: int,
    l_max: int,
    ef: int,
    k: int,
    max_steps: int,
    expand: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projected-traversal search: the beam scores ``||x||^2 - 2 q^ . x^``
    from the bf16 PCA mirror (the distance estimate less the query's
    constant); the ef candidates are rescored exactly in f32 before the
    top-k cut. The bf16 x bf16 products are exact in f32 and summed in
    f32. Returns (d_sq f32[B, k], slots int32[B, k])."""
    b = queries.shape[0]
    qp = queries_proj.to(rp.dtype).float()

    def score(idx):
        safe = idx.clamp_min(0).long()
        dots = torch.bmm(rp[safe].float(), qp[:, :, None])[..., 0]
        d = xsq[safe] - 2.0 * dots
        return torch.where((idx >= 0) & has_emb[safe], d, BIG)

    rd, rs = _beam_search_scored(graph, score, emb.shape[0], b,
                                 queries.device, M, l_max, ef, max_steps,
                                 expand)
    rd = gather_l2_sq(queries, emb, rs, has_emb[rs.clamp_min(0).long()])
    return masked_top_k_smallest(rd, rs, k)


def delete_slot(graph: Graph, slot: int, M: int, l_max: int) -> Graph:
    """Remove a node in place: drop every edge to it anywhere in the table
    (backlink pruning makes edges asymmetric, and a surviving incoming edge
    would alias whatever node later recycles the slot), clear its rows, and
    re-elect the entry point as the highest-level survivor (the first such
    slot)."""
    levels = graph.levels
    if int(levels[slot]) < 0:
        return graph
    nb = graph.neighbors
    nb.masked_fill_(nb == slot, -1)
    nb[slot] = -1
    levels[slot] = -1
    if graph.entry == slot:
        best = int(torch.argmax(levels))
        left = int(levels[best])
        graph.entry = best if left >= 0 else -1
        graph.entry_level = left if left >= 0 else -1
    return graph


# -- streaming insert --------------------------------------------------------
def _center_dists(emb: torch.Tensor, has_emb: torch.Tensor,
                  centers: torch.Tensor, cand: torch.Tensor,
                  rows: int = 1 << 16) -> torch.Tensor:
    """f32[R, C]: squared L2 from row ``emb[centers[r]]`` to each
    ``emb[cand[r, c]]`` (BIG where cand < 0 or the row is invalid),
    ``rows`` gathered rows at a time: the grouped commit's [E, 2 width, d]
    gather would be 3.2 GB at B = 1024, M = 16, d = 768 in one piece."""
    step = max(1, rows // max(1, cand.shape[1]))
    return torch.cat([
        _dist_to(emb[centers[s:s + step].long()].float(), emb,
                 cand[s:s + step], has_emb)
        for s in range(0, cand.shape[0], step)])


def construction_search(
    graph: Graph,
    emb: torch.Tensor,            # f32[capacity, d]
    has_emb: torch.Tensor,        # bool[capacity]
    queries: torch.Tensor,        # f32[B, d], the new points
    target_levels: torch.Tensor,  # int32[B]
    M: int,
    l_max: int,
    ef_construction: int,
    max_steps: int,
    expand: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam candidates of each new point against the pre-batch graph:
    greedy descent to one level above its target, then a
    ``beam_layer_unified`` of width ef_construction per level from
    min(target, entry_level) down, each level entered at the previous
    level's closest candidate. Returns (cand_d f32[B, l_max, efc],
    cand_s int32[B, l_max, efc]); levels above min(target, entry_level)
    come back (BIG, -1)."""
    b = queries.shape[0]
    dev = queries.device
    efc = ef_construction

    def score(idx):
        return _dist_to(queries, emb, idx, has_emb)

    tgt = target_levels.to(device=dev, dtype=torch.int32)
    entry = torch.full((b,), graph.entry, dtype=torch.int32, device=dev)
    entry_d = score(entry[:, None])[:, 0]
    cur, cur_d = greedy_descent(graph, score, entry, entry_d, tgt + 1, M,
                                l_max)
    start_level = tgt.clamp(max=graph.entry_level)
    cand_d = torch.full((b, l_max, efc), BIG, dtype=torch.float32,
                        device=dev)
    cand_s = torch.full((b, l_max, efc), -1, dtype=torch.int32, device=dev)
    for level in range(l_max - 1, -1, -1):
        act = (level <= start_level) & (graph.entry >= 0)
        if not bool(act.any()):
            continue
        rd, rs = beam_layer_unified(graph, score, emb.shape[0], cur, cur_d,
                                    act, level=level, ef=efc, M=M,
                                    max_steps=max_steps, expand=expand)
        rd = torch.where(act[:, None], rd, BIG)
        rs = torch.where(act[:, None], rs, -1)
        cand_d[:, level], cand_s[:, level] = rd, rs
        # the next level down starts at this level's closest candidate
        j = torch.argmin(rd, dim=1, keepdim=True)
        bd, bs = torch.gather(rd, 1, j)[:, 0], torch.gather(rs, 1, j)[:, 0]
        move = act & (bd < BIG_THRESH)
        cur = torch.where(move, bs, cur)
        cur_d = torch.where(move, bd, cur_d)
    return cand_d, cand_s


def construction_candidates_exact(
    graph: Graph,
    emb: torch.Tensor,          # f32[capacity, d]
    has_emb: torch.Tensor,      # bool[capacity]
    queries: torch.Tensor,      # f32[B, d], the new points
    l_max: int,
    ef_construction: int,
    ef_upper: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact insert candidates: per new point and level l, the nearest
    ``k_l`` committed rows with ``levels >= l`` (k_0 = ef_construction,
    k_l = min(ef_upper, ef_construction) above), by the masked exact scan
    ``exact_search``: the ``l2_topk`` kernel on a CUDA table while
    k_l <= 256 (a larger ef_construction takes the tiled plain scan, the
    rule FlatIndex follows). The mask includes ``levels >= 0``: the
    batch's rows are in the table, valid, before the commit, with level
    -1, so no point finds itself or its batch mates (the commit adds the
    earlier ones through ``batch_d``).

    The table's norms are computed once for all levels. Level 0 is one
    scan of the whole table; above it, each level scans a gathered table
    of its own rows only (~1/M of the level below), so a batch costs
    ~1 + 1/(M - 1) full scans and 1 + (the pre-batch entry level)
    launches.

    Returns (cand_d f32[B, l_max, efc], cand_s int32[B, l_max, efc]),
    ascending per level, (BIG, -1) padded."""
    b = queries.shape[0]
    dev = queries.device
    efc = ef_construction
    x_sq = squared_norms(emb)
    cand_d = torch.full((b, l_max, efc), BIG, dtype=torch.float32,
                        device=dev)
    cand_s = torch.full((b, l_max, efc), -1, dtype=torch.int32, device=dev)
    levels = graph.levels
    k0 = min(efc, emb.shape[0])
    d, i = exact_search(queries, emb, has_emb & (levels >= 0), k0, x_sq=x_sq)
    cand_d[:, 0, :k0], cand_s[:, 0, :k0] = d, i
    up = torch.nonzero(levels >= 1).flatten()
    up_levels = levels[up]
    k_up = min(ef_upper, efc)
    for level in range(1, l_max):
        rows = up[up_levels >= level]
        if rows.numel() == 0:
            break
        k = min(k_up, rows.numel())
        d, i = exact_search(queries, emb[rows], has_emb[rows], k,
                            x_sq=x_sq[rows])
        cand_d[:, level, :k] = d
        cand_s[:, level, :k] = torch.where(
            i >= 0, rows[i.clamp_min(0).long()].int(), -1)
    return cand_d, cand_s


def commit_inserts(
    graph: Graph,
    emb: torch.Tensor,
    has_emb: torch.Tensor,
    new_slots: torch.Tensor,    # int32[B], -1 = padding (a full no-op)
    new_levels: torch.Tensor,   # int32[B]
    cand_d: torch.Tensor,       # f32[B, l_max, efc]
    cand_s: torch.Tensor,       # int32[B, l_max, efc]
    batch_d: torch.Tensor,      # f32[B, B] exact intra-batch distances
    M: int,
    l_max: int,
    ef_construction: int,
) -> Graph:
    """Sequential edge commit, one batch item at a time, in place: each
    item's candidates, merged with the earlier batch members at their
    exact ``batch_d`` distances, give its M closest per level as its
    forward row; each selected neighbour appends a backlink to its row, or
    keeps the closest ``width`` of its row and the new node when the row
    is full. An item whose slot is -1 or already in the graph is skipped;
    the first item into an empty graph only becomes the entry."""
    b = new_slots.shape[0]
    efc = ef_construction
    nb, levels = graph.neighbors, graph.levels
    dev = nb.device
    new_slots = new_slots.to(device=dev, dtype=torch.int32)
    new_levels = new_levels.to(device=dev, dtype=torch.int32)
    slots_h, levels_h = new_slots.tolist(), new_levels.tolist()
    # one read of the slots' levels; a slot committed earlier in this
    # loop is in ``done``
    was_in = levels[new_slots.clamp_min(0).long()].tolist()
    done: set = set()
    earlier = torch.arange(b, device=dev)
    rows_m = torch.arange(M, device=dev)
    for i in range(b):
        slot, lvl = slots_h[i], levels_h[i]
        if slot < 0 or was_in[i] >= 0 or slot in done:
            continue
        done.add(slot)
        if graph.entry >= 0:
            bd_i = torch.where(earlier < i, batch_d[i], BIG)
            for level in range(lvl + 1):
                start = level_col_start(level, M)
                width = level_width(level, M)
                md, ms = stable_top_k_smallest(
                    torch.cat([cand_d[i, level],
                               torch.where(new_levels >= level, bd_i, BIG)]),
                    torch.cat([cand_s[i, level], new_slots]), efc)
                sel_s = ms[:M]
                sel_ok = sel_s >= 0
                fwd = torch.full((width,), -1, dtype=torch.int32, device=dev)
                fwd[:M] = torch.where(sel_ok, sel_s, -1)
                nb[slot, start:start + width] = fwd
                # backlinks: the selected slots are unique, so all M rows
                # update in one gather / compute / scatter
                n_safe = sel_s.clamp_min(0).long()
                rows = nb[n_safe, start:start + width]
                free = rows < 0
                first_free = torch.argmax(free.int(), dim=1)
                appended = rows.clone()
                appended[rows_m, first_free] = slot
                cand = torch.cat([rows, rows.new_full((M, 1), slot)], 1)
                _, pruned = stable_top_k_smallest(
                    _center_dists(emb, has_emb, n_safe, cand), cand, width)
                new_rows = torch.where(free.any(1)[:, None], appended, pruned)
                keep = sel_ok.nonzero().flatten()
                nb[sel_s[keep].long(), start:start + width] = new_rows[keep]
        levels[slot] = lvl
        if graph.entry < 0 or lvl > graph.entry_level:
            graph.entry, graph.entry_level = slot, lvl
    return graph


def commit_inserts_grouped(
    graph: Graph,
    emb: torch.Tensor,
    has_emb: torch.Tensor,
    new_slots: torch.Tensor,    # int32[B], -1 = padding (a full no-op)
    new_levels: torch.Tensor,   # int32[B]
    cand_d: torch.Tensor,       # f32[B, l_max, efc]
    cand_s: torch.Tensor,       # int32[B, l_max, efc]
    batch_d: torch.Tensor,      # f32[B, B]
    M: int,
    l_max: int,
    ef_construction: int,
) -> Graph:
    """Batch-parallel edge commit, in place; the same graph as
    :func:`commit_inserts` up to the order within a row. Item i's
    selection depends only on its candidates and the earlier batch items
    (a causal [B, B] mask), so all selections run at once; and the fold
    "append if free, else keep the closest ``width``" of a row is the
    top-``width`` of the row and all its incoming backlinks. So per level:
    the forward rows are written (slots are unique), then the backlinks
    are grouped by destination (a sort by (destination, distance) and
    ranks within each run; the closest ``width`` are kept) and each
    destination row merges once, in parallel. Only the real destinations
    are scored, ``_center_dists``' chunk at a time."""
    b = new_slots.shape[0]
    efc = ef_construction
    nb, levels = graph.neighbors, graph.levels
    dev = nb.device
    capacity = levels.shape[0]
    new_slots = new_slots.to(device=dev, dtype=torch.int32)
    new_levels = new_levels.to(device=dev, dtype=torch.int32)
    slot_safe = new_slots.clamp_min(0).long()
    do = (levels[slot_safe] < 0) & (new_slots >= 0)
    ar = torch.arange(b, device=dev)
    causal = ar[None, :] < ar[:, None]     # [i, j]: j precedes i
    src = slot_safe.repeat_interleave(M).int()
    src_do = do.repeat_interleave(M)
    batch_s = new_slots[None, :].expand(b, b)

    for level in range(l_max):
        lvl_active = do & (level <= new_levels)
        if not bool(lvl_active.any()):
            continue
        start = level_col_start(level, M)
        width = level_width(level, M)
        # selection, all items at once (the first item into an empty
        # graph has no candidates: its selection is empty by itself)
        b_lvl = torch.where(causal & (new_levels[None, :] >= level),
                            batch_d, BIG)
        md, ms = stable_top_k_smallest(
            torch.cat([cand_d[:, level], b_lvl], 1),
            torch.cat([cand_s[:, level], batch_s], 1), efc)
        sel_d, sel_s = md[:, :M], ms[:, :M]
        sel_ok = (sel_s >= 0) & lvl_active[:, None]

        # forward rows (disjoint slots: one scatter)
        fwd = torch.full((b, width), -1, dtype=torch.int32, device=dev)
        fwd[:, :M] = torch.where(sel_ok, sel_s, -1)
        act = lvl_active.nonzero().flatten()
        nb[slot_safe[act], start:start + width] = fwd[act]

        # backlinks grouped by destination: sort by (dst, distance), the
        # invalid ones (dst = capacity) last
        dst = torch.where(sel_ok.reshape(-1) & src_do, sel_s.reshape(-1),
                          capacity)
        d_e = torch.where(dst < capacity, sel_d.reshape(-1), BIG)
        by_d = torch.sort(d_e, stable=True).indices
        order = by_d[torch.sort(dst[by_d], stable=True).indices]
        n_live = int((dst < capacity).sum())
        if n_live == 0:
            continue
        dst_s, src_s = dst[order[:n_live]], src[order[:n_live]]
        first = torch.ones(n_live, dtype=torch.bool, device=dev)
        first[1:] = dst_s[1:] != dst_s[:-1]
        seg = torch.cumsum(first.int(), 0) - 1
        pos = torch.arange(n_live, device=dev)
        rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
        keep = rank < width
        seg_dst = dst_s[first].long()
        inc = torch.full((seg_dst.shape[0], width), -1, dtype=torch.int32,
                         device=dev)
        inc[seg[keep], rank[keep]] = src_s[keep]
        cand = torch.cat([nb[seg_dst, start:start + width], inc], 1)
        _, merged = stable_top_k_smallest(
            _center_dists(emb, has_emb, seg_dst, cand), cand, width)
        nb[seg_dst, start:start + width] = merged

    # levels, and the entry: the first item of the highest level, if above
    # the old entry's
    act = do.nonzero().flatten()
    levels[slot_safe[act]] = new_levels[act]
    if act.numel():
        lv = torch.where(do, new_levels, -1)
        best = int(torch.argmax(lv))
        best_lvl = int(lv[best])
        if graph.entry < 0 or best_lvl > graph.entry_level:
            graph.entry, graph.entry_level = int(slot_safe[best]), best_lvl
    return graph


def _batch_dists(new_emb: torch.Tensor, new_slots: torch.Tensor
                 ) -> torch.Tensor:
    """Exact intra-batch distances f32[B, B], BIG on padding rows and
    columns."""
    d = l2_sq_pairwise(new_emb, new_emb)
    pad = new_slots < 0
    return torch.where(pad[None, :] | pad[:, None], BIG, d)


_COMMITS = {"grouped": commit_inserts_grouped, "sequential": commit_inserts}


def _commit(commit: str):
    if commit not in _COMMITS:
        raise ValueError(f"commit must be one of {sorted(_COMMITS)}, "
                         f"got {commit!r}")
    return _COMMITS[commit]


def insert_step(
    graph: Graph,
    emb: torch.Tensor,
    has_emb: torch.Tensor,
    new_emb: torch.Tensor,      # f32[B, d] (padding rows may be zeros)
    new_slots: torch.Tensor,    # int32[B], -1 = padding
    new_levels: torch.Tensor,   # int32[B]
    M: int,
    l_max: int,
    ef_construction: int,
    max_steps: int,
    commit: str = "grouped",
    expand: int = 1,
) -> Graph:
    """Streaming insert with beam candidates: ``construction_search``
    (``expand`` candidates popped a step), the intra-batch distances, and
    the ``commit`` ("grouped" or "sequential") edge commit."""
    commit_fn = _commit(commit)
    cd, cs = construction_search(
        graph, emb, has_emb, new_emb, new_levels, M=M, l_max=l_max,
        ef_construction=ef_construction, max_steps=max_steps, expand=expand)
    return commit_fn(graph, emb, has_emb, new_slots, new_levels, cd, cs,
                     _batch_dists(new_emb, new_slots), M=M, l_max=l_max,
                     ef_construction=ef_construction)


def insert_step_exact(
    graph: Graph,
    emb: torch.Tensor,
    has_emb: torch.Tensor,
    new_emb: torch.Tensor,      # f32[B, d] (padding rows may be zeros)
    new_slots: torch.Tensor,    # int32[B], -1 = padding
    new_levels: torch.Tensor,   # int32[B]
    M: int,
    l_max: int,
    ef_construction: int,
    ef_upper: int,
    commit: str = "grouped",
) -> Graph:
    """Streaming insert with exact candidates
    (``construction_candidates_exact``), the intra-batch distances, and
    the ``commit`` edge commit."""
    commit_fn = _commit(commit)
    cd, cs = construction_candidates_exact(
        graph, emb, has_emb, new_emb, l_max=l_max,
        ef_construction=ef_construction, ef_upper=ef_upper)
    return commit_fn(graph, emb, has_emb, new_slots, new_levels, cd, cs,
                     _batch_dists(new_emb, new_slots), M=M, l_max=l_max,
                     ef_construction=ef_construction)
