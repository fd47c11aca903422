"""HNSW graph tables and the classic best-first search, batched (port of
vector_db_tpu/index/hnsw_kernels.py).

The graph is one ``int32[capacity, NCOLS]`` neighbor table, -1 padded:
level-0 edges occupy columns [0, 2M), level-l >= 1 edges [M(l+1), M(l+2)).
Search is a best-first beam: each step pops the nearest unexpanded
candidate(s), gathers their neighbor rows, scores the unvisited neighbors
with exact f32 distances, and merges them into an ef-wide pool.

JAX ``vmap``s a ``while_loop`` per query. Here the queries run together as
one batched loop over [B, ...] tensors: each query carries its own
``active`` flag, a query whose loop condition fails keeps its state (every
update is a ``torch.where`` on it), and the loop ends when no query is
active or at ``max_steps``. The visited set is a [B, capacity/32] int32
bitmap; newly visited ids are unique per step (deduplicated when E > 1 rows
are expanded), so ``scatter_add_`` of their bits is a bitwise or.

Graph tensors are updated in place (``delete_slot``): a 1M-row table is
0.45 GB, and a copy per mutation would double it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from vector_db_tpu_torch.ops.distance import BIG, BIG_THRESH, gather_l2_sq
from vector_db_tpu_torch.ops.topk import later_copies, masked_top_k_smallest


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
    b = queries.shape[0]
    dev = queries.device
    capacity = emb.shape[0]
    rm = filter_mask if use_filter else None

    def score(idx):
        return _dist_to(queries, emb, idx, has_emb)

    def res_ok(idx):
        return has_emb[idx.clamp_min(0).long()]

    entry = torch.full((b,), graph.entry, dtype=torch.int32, device=dev)
    entry_d = score(entry[:, None])[:, 0]
    cur, cur_d = greedy_descent(graph, score, entry, entry_d, 1, M, l_max)
    active = torch.full((b,), graph.entry >= 0, dtype=torch.bool, device=dev)
    if rm is None:
        rd, rs = beam_layer_unified(graph, score, capacity, cur, cur_d, active,
                                    level=0, ef=ef, M=M, max_steps=max_steps,
                                    expand=expand)
    else:
        rd, rs = beam_layer(graph, score, capacity, res_ok, cur, cur_d, active,
                            res_mask=rm, level=0, ef=ef, M=M,
                            max_steps=max_steps, pool=pool, expand=expand)
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
