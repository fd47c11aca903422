"""Wide-beam HNSW search: frontier-parallel graph traversal (port of
vector_db_tpu/index/wide_beam.py).

Each step pops a frontier of the F best unexpanded pool entries, gathers
their F * 2M level-0 neighbors, scores them against an augmented bf16
mirror row ``[-2·x̂, ‖x‖²]`` (one row gather and a dot with ``[q̂, 1]``),
and merges them into a P = ef wide pool. Seeds are the highest-level graph
nodes, scored once; the final R = rerank_k best pool entries are reranked
exactly in f32.

Differences from the JAX function, all on selection only:

- ``lax.approx_min_k`` (TPU hardware) becomes exact ``torch.topk``;
- the pool merge is an exact stable top-P: with ``merge_kernel=True`` the
  hand-written ``sorted_topk`` kernel (``ops/cuda/sorted_topk.py``) while
  P <= 8192; otherwise, and above that, its plain version (a stable
  ``torch.sort``), which gives the same pool;
- a mirror row's score is a product and a pairwise sum in a fixed order
  (:func:`_fixed_sum`, elementwise f32 operations only), so one row scored
  in any step, chunk or batch shape gets a bit-identical score: the window
  dedup relies on duplicate copies landing adjacent;
- the pool-membership masks (``seen_mask``, the pop's expanded marks) are
  sorted-membership tests (``searchsorted``) instead of [B, K, P] and
  [B, P, F] broadcast compares, which would be 15 and 0.47 G elements per
  step at the 1M shape.

Beside it: ``build_aug_table_pq`` (the mirror of PQ-decoded rows, for
ADC-scored traversal), ``build_inline_tables`` (int8 inline neighbor
replication: each node's W neighbors' quantized mirror rows in one
contiguous block) and ``beam_search`` (the pool-free beam: the next frontier
is the top F of this step's candidates, every frontier is kept, and one
selection over the trajectory picks the rerank set). The inline int8 dot is
a product of widened int8 values summed in f32: every partial sum is an
integer below 2^24 (127^2 * 128 = 2,064,512), so it is exact in any order
and equals the JAX package's int32 dot converted to f32. ``torch.round`` and
``jnp.round`` both round half to even, so the int8 tables equal JAX's for
equal inputs. Selection in ``beam_search`` is exact and stable
(:func:`ops.topk.smallest_stable`), where JAX uses ``approx_min_k``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vector_db_tpu_torch.device import require_f32_matmul
from vector_db_tpu_torch.index.pq import _decode
from vector_db_tpu_torch.ops.cuda.sorted_topk import (
    MAX_TOPK,
    sorted_topk,
    sorted_topk_plain,
)
from vector_db_tpu_torch.ops.distance import BIG, BIG_THRESH, squared_norms
from vector_db_tpu_torch.ops.topk import later_copies, smallest_stable

_ROWS = 65536            # table rows per pass of the mirror build
_SCORE_ELEMS = 1 << 28   # bound on one scoring chunk's [B, rows, dpa] f32
_LANES = 128             # the inline table's row width is a multiple of it


def build_aug_table(
    emb: torch.Tensor,        # f32[capacity, dim]
    has_emb: torch.Tensor,    # bool[capacity]
    proj: Optional[torch.Tensor],  # f32[dim, dp] or None (identity mirror)
) -> torch.Tensor:
    """Augmented scoring mirror: bf16[capacity, dpa] rows ``[-2·x̂, ‖x‖²]``
    (dpa = dp + 8, zero padded). ``‖x‖²`` is the full-space norm; invalid
    rows carry ‖x‖² = BIG so they never enter the pool. The projection is a
    true-f32 product."""
    if proj is not None:
        require_f32_matmul(emb)
    xsq = torch.where(has_emb, squared_norms(emb), BIG)
    dp = emb.shape[1] if proj is None else proj.shape[1]
    aug = torch.zeros((emb.shape[0], dp + 8), dtype=torch.bfloat16,
                      device=emb.device)
    for s in range(0, emb.shape[0], _ROWS):
        x = emb[s:s + _ROWS]
        x_m = x if proj is None else x @ proj
        aug[s:s + _ROWS, :dp] = (-2.0 * x_m).to(torch.bfloat16)
    aug[:, dp] = xsq.to(torch.bfloat16)
    return aug


def build_aug_table_pq(
    codes: torch.Tensor,         # int[capacity, m] PQ codes
    codebooks: torch.Tensor,     # f32[m, ksub, subdim]
    rotation: Optional[torch.Tensor],  # f32[dim, dim] OPQ or None
    has_emb: torch.Tensor,       # bool[capacity]
    proj: Optional[torch.Tensor],  # f32[dim, dp] PCA (input space) or None
) -> torch.Tensor:
    """Augmented mirror of PQ-DECODED rows ``[-2 R_p^T decode(x),
    ||decode(x)||^2]``: scoring a query against it estimates
    ``||q - decode(x)||^2`` up to the query's constant (the ADC estimate,
    HNSW-over-PQ traversal), as the same row dot ``wide_search`` runs.
    Decodes ``_ROWS`` rows at a time; products are true f32."""
    if rotation is not None or proj is not None:
        require_f32_matmul(codebooks)
    cap = codes.shape[0]
    dp = codebooks.shape[0] * codebooks.shape[2] if proj is None \
        else proj.shape[1]
    aug = torch.zeros((cap, dp + 8), dtype=torch.bfloat16,
                      device=codebooks.device)
    for s in range(0, cap, _ROWS):
        dec = _decode(codes[s:s + _ROWS], codebooks)   # code space
        if rotation is not None:
            dec = dec @ rotation.T
        xsq = (dec * dec).sum(-1)
        dm = dec if proj is None else dec @ proj
        aug[s:s + _ROWS, :dp] = (-2.0 * dm.to(torch.bfloat16).float()).to(
            torch.bfloat16)
        aug[s:s + _ROWS, dp] = torch.where(has_emb[s:s + _ROWS], xsq,
                                           BIG).to(torch.bfloat16)
    return aug


def build_inline_tables(
    neighbors0: torch.Tensor,    # int32[capacity, W] level-0 adjacency
    emb: torch.Tensor,           # f32[capacity, dim]
    has_emb: torch.Tensor,       # bool[capacity]
    proj: Optional[torch.Tensor],  # f32[dim, dp] or None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inline neighbor replication: each node's W neighbors' int8 mirror
    rows as one contiguous [W, dp128] block (dp zero padded to a multiple
    of 128), with each neighbor's dequantization scale and full-space norm.
    Rows are quantized by ``round(x^ / scale)``, scale = max |x^| / 127.
    Returns (nbr_i8 int8[capacity, W, dp128], nbr_scale f32[capacity, W],
    nbr_xsq f32[capacity, W]); capacity * W * dp128 bytes (4.3 GB at 1M,
    W = 32, dp 120), rebuilt from the graph and the table, never saved."""
    if proj is not None:
        require_f32_matmul(emb)
    cap, w = neighbors0.shape
    dp = emb.shape[1] if proj is None else proj.shape[1]
    dp128 = -(-dp // _LANES) * _LANES
    xi8 = torch.zeros((cap, dp128), dtype=torch.int8, device=emb.device)
    scale = torch.empty((cap,), device=emb.device)
    for s in range(0, cap, _ROWS):
        x_m = emb[s:s + _ROWS] if proj is None else emb[s:s + _ROWS] @ proj
        sc = x_m.abs().amax(1).clamp_min(1e-9) / 127.0
        scale[s:s + _ROWS] = sc
        xi8[s:s + _ROWS, :dp] = torch.round(x_m / sc[:, None]).to(
            torch.int8)
    xsq = torch.where(has_emb, squared_norms(emb), BIG)
    nbr_i8 = torch.empty((cap, w, dp128), dtype=torch.int8,
                         device=emb.device)
    rows = max(1, _ROWS // w)
    for s in range(0, cap, rows):
        nbr_i8[s:s + rows] = xi8[neighbors0[s:s + rows].clamp_min(0).long()]
    safe = neighbors0.clamp_min(0).long()
    ok = neighbors0 >= 0
    return (nbr_i8, torch.where(ok, scale[safe], 0.0),
            torch.where(ok, xsq[safe], BIG))


def _inline_queries(queries_aug: torch.Tensor, dp_i: int):
    """The int8 query mirror of the inline tables: the augmented query's
    mirror columns (its [.., 1, 0..] tail zeroed, padded to the table's
    dp_i), quantized like the rows. Returns (q_i8 as f32 [B, dp_i], its
    scale f32[B])."""
    b, dpa = queries_aug.shape
    dp_real = dpa - 8
    qm = torch.zeros((b, dp_i), device=queries_aug.device)
    cols = min(dp_i, dpa, dp_real)
    qm[:, :cols] = queries_aug[:, :cols]
    q_scale = qm.abs().amax(1).clamp_min(1e-9) / 127.0
    return torch.round(qm / q_scale[:, None]).to(torch.int8).float(), q_scale


def _inline_scores(inline_tabs, frontier: torch.Tensor, q_i8: torch.Tensor,
                   q_scale: torch.Tensor) -> torch.Tensor:
    """f32[B, F * W] estimates ``nbr_xsq - 2 q_scale nbr_scale (nbr_i8 .
    q_i8)`` of every frontier node's inline neighbors (the frontier holds
    -1 where invalid: those rows read slot 0, callers mask them). The int8
    dot is exact in f32 (module docstring); queries run in chunks that keep
    the widened [b, F, W, dp] block within ``_SCORE_ELEMS``."""
    nbr_i8, nbr_scale, nbr_xsq = inline_tabs
    b, f = frontier.shape
    w, dp = nbr_i8.shape[1:]
    step = max(1, _SCORE_ELEMS // max(1, f * w * dp))
    out = torch.empty((b, f, w), device=q_i8.device)
    for s in range(0, b, step):
        fs = frontier[s:s + step].clamp_min(0).long()
        dots = (nbr_i8[fs].float() @ q_i8[s:s + step, None, :, None])[..., 0]
        out[s:s + step] = nbr_xsq[fs] - (
            (2.0 * q_scale[s:s + step])[:, None, None] * nbr_scale[fs]) * dots
    return out.reshape(b, f * w)


def aug_queries(
    queries: torch.Tensor,      # f32[B, dim]
    proj: Optional[torch.Tensor],  # f32[dim, dp] or None
    dpa: int,
) -> torch.Tensor:
    """Query-side augmentation ``[q̂, 1, 0...]`` matching build_aug_table."""
    if proj is not None:
        require_f32_matmul(queries)
    q_m = queries if proj is None else queries @ proj
    dp = q_m.shape[1]
    qa = torch.zeros((queries.shape[0], dpa), dtype=torch.float32,
                     device=queries.device)
    qa[:, :dp] = q_m
    qa[:, dp] = 1.0
    return qa


def _fixed_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by halving, in an order fixed by the width
    alone: elementwise f32 adds, so every row's result is the same bits in
    any batch shape and on any device."""
    while p.shape[-1] > 1:
        w = p.shape[-1]
        h = w // 2
        s = p[..., :h] + p[..., h:2 * h]
        if w % 2:
            s[..., :1] += p[..., 2 * h:]
        p = s
    return p[..., 0]


def _aug_scores(aug: torch.Tensor, idx: torch.Tensor, qa: torch.Tensor,
                chunks: int = 1) -> torch.Tensor:
    """Mirror scores f32[B, K] of rows ``aug[idx]`` (idx [B, K]; -1 scores
    row 0, callers mask it) against ``qa`` f32[B, dpa] (the bf16 query's
    values): bf16 x bf16 products are exact in f32, summed by
    :func:`_fixed_sum`. The candidate axis runs in at least ``chunks``
    pieces, each within ``_SCORE_ELEMS`` f32 elements."""
    b, k = idx.shape
    dpa = aug.shape[1]
    step = max(1, min(-(-k // max(1, chunks)),
                      _SCORE_ELEMS // max(1, b * dpa)))
    out = torch.empty((b, k), dtype=torch.float32, device=aug.device)
    for s in range(0, k, step):
        rows = aug[idx[:, s:s + step].clamp_min(0).long()].float()
        rows.mul_(qa[:, None, :])
        out[:, s:s + step] = _fixed_sum(rows)
    return out


def _member(x: torch.Tensor, sets: torch.Tensor) -> torch.Tensor:
    """bool[B, X]: whether each x[b, i] is among sets[b, :] (int32 rows)."""
    ss = torch.sort(sets, dim=1).values
    pos = torch.searchsorted(ss, x.contiguous()).clamp_max(ss.shape[1] - 1)
    return torch.gather(ss, 1, pos) == x


def _shift(x: torch.Tensor, w: int, fill) -> torch.Tensor:
    """x shifted right by w columns (w > 0) or left by -w, ``fill`` in."""
    pad = torch.full((x.shape[0], abs(w)), fill, dtype=x.dtype,
                     device=x.device)
    if w > 0:
        return torch.cat([pad, x[:, :-w]], 1)
    return torch.cat([x[:, -w:], pad], 1)


def score_chunks(b: int, frontiers, width: int,
                 rows: int = 2_097_152) -> int:
    """``wide_search``'s ``score_chunks`` for a batch of ``b`` queries:
    the per-step [B, F*W, dpa] mirror gather capped at ~``rows`` rows, the
    chunk count dividing every segment's candidate width F*W."""
    need = b * max(frontiers) * width
    chunks = 1
    while (need // chunks > rows
           and all((f * width) % (2 * chunks) == 0 for f in frontiers)):
        chunks *= 2
    return chunks


def wide_search(
    neighbors0: torch.Tensor,   # int32[capacity, W] level-0 adjacency
    aug: torch.Tensor,          # bf16[capacity, dpa] scoring mirror
    emb: torch.Tensor,          # f32[capacity, dim] exact rerank table
    has_emb: torch.Tensor,      # bool[capacity]
    seed_slots: torch.Tensor,   # int32[S], -1 padded
    queries: torch.Tensor,      # f32[B, dim]
    queries_aug: torch.Tensor,  # f32[B, dpa]
    ef: int,
    F: int,
    T: int,
    k: int,
    rerank_k: int,
    dedup_window: int = 16,
    seen_mask: bool = True,
    inline_tabs=None,
    score_chunks: int = 1,
    merge_kernel: bool = False,
    schedule: Optional[Tuple[Tuple[int, int], ...]] = None,
    res_mask: Optional[torch.Tensor] = None,
    early_exit: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched wide-beam search. Returns (d_sq f32[B, k], slots int32[B, k])
    sorted ascending, (BIG, -1) padded; distances exact (difference-form
    rerank).

    ``seen_mask`` masks candidates already in the pool before the merge;
    the window dedup after it stays either way. ``merge_kernel`` merges
    through ``sorted_topk``. ``schedule`` ``((F1, T1), (F2, T2), ...)``
    runs T1 steps at frontier F1, then T2 at F2, ... ``res_mask``
    (bool[capacity]) is the filter contract: masked-out nodes navigate,
    and only matching nodes enter a separate R-wide result pool merged per
    step. ``inline_tabs`` (:func:`build_inline_tables`) scores candidates
    from one int8 inline block per frontier node instead of gathering a
    mirror row per candidate. ``early_exit`` stops once no query's best unexpanded pool entry
    beats its R-th best kept score (T is then an upper bound); it ignores
    ``schedule``."""
    b = queries.shape[0]
    dev = queries.device
    P = ef
    R = min(max(rerank_k, k), P)
    qa = queries_aug.to(torch.bfloat16).float()
    big16 = torch.tensor(BIG, dtype=torch.bfloat16, device=dev)

    # ---- seed the pool: score the fixed seed set once ----
    seed_b = seed_slots[None, :].expand(b, seed_slots.shape[0])
    d_seed = torch.where(seed_b >= 0, _aug_scores(aug, seed_b, qa), BIG)
    if d_seed.shape[1] < P:
        s_pad = P - d_seed.shape[1]
        d_seed = torch.cat([d_seed, d_seed.new_full((b, s_pad), BIG)], 1)
        seed_b = torch.cat([seed_b, seed_b.new_full((b, s_pad), -1)], 1)
    pool_d, pos = torch.topk(d_seed, P, dim=1, largest=False, sorted=True)
    pool_s0 = torch.where(pool_d < BIG_THRESH, torch.gather(seed_b, 1, pos),
                          -1)
    # pool keys in bf16 (selection only; the rerank is exact f32); (slot,
    # expanded) packed into one int32 as slot * 2 | e, slot -1 packs to -2
    pool_d = pool_d.to(torch.bfloat16)
    pool_se = pool_s0 * 2
    res_d = res_s = None
    if inline_tabs is not None:
        q_i8, q_scale = _inline_queries(queries_aug, inline_tabs[0].shape[-1])
    if res_mask is not None:
        ok_seed = (seed_b >= 0) & res_mask[seed_b.clamp_min(0).long()]
        res_d, rpos = torch.topk(torch.where(ok_seed, d_seed, BIG), R, dim=1,
                                 largest=False, sorted=True)
        res_s = torch.where(res_d < BIG_THRESH,
                            torch.gather(seed_b, 1, rpos), -1)

    def step(f, pool_d, pool_se, res_d, res_s):
        pool_sid = pool_se >> 1
        pool_e = (pool_se & 1) == 1
        # ---- pop the F best unexpanded entries ----
        unexp = torch.where(pool_e | (pool_sid < 0), BIG, pool_d.float())
        fd, fpos = torch.topk(unexp, f, dim=1, largest=False, sorted=True)
        frontier = torch.gather(pool_sid, 1, fpos)
        fvalid = (fd < BIG_THRESH) & (frontier >= 0)
        frontier = torch.where(fvalid, frontier, -1)
        # mark EVERY pool copy of a popped slot expanded
        hit = _member(pool_sid, frontier) & (pool_sid >= 0)
        pool_se = pool_se | hit.int()

        # ---- expand: gather adjacency + score candidates ----
        cand = neighbors0[frontier.clamp_min(0).long()]       # [B, F, W]
        cand = torch.where(fvalid[:, :, None], cand, -1).reshape(b, -1)
        if inline_tabs is not None:
            d_new = _inline_scores(inline_tabs, frontier, q_i8, q_scale)
        else:
            d_new = _aug_scores(aug, cand, qa, score_chunks)
        if res_mask is not None:
            # result-pool merge BEFORE the seen mask: a matching node first
            # scored this step enters results even if it is already pooled
            ok_res = (cand >= 0) & res_mask[cand.clamp_min(0).long()]
            res_d, rpos = torch.topk(
                torch.cat([res_d, torch.where(ok_res, d_new, BIG)], 1), R,
                dim=1, largest=False, sorted=True)
            res_s = torch.gather(torch.cat([res_s, cand], 1), 1, rpos)
            res_s = torch.where(res_d < BIG_THRESH, res_s, -1)
            # window-dedup the result pool: copies of one node carry
            # bit-identical scores and land adjacent
            dupr = torch.zeros_like(res_s, dtype=torch.bool)
            for w in range(1, min(max(dedup_window, 1), 8, R - 1) + 1):
                dupr |= res_s == _shift(res_s, w, -3)
            res_d = torch.where(dupr, BIG, res_d)
            res_s = torch.where(dupr, -1, res_s)

        ok_new = cand >= 0
        if seen_mask:
            ok_new &= ~_member(cand, pool_sid)
        d_new = torch.where(ok_new, d_new, BIG)

        # ---- merge: exact top-P of pool ∪ new ----
        cat_d = torch.cat([pool_d, d_new.to(torch.bfloat16)], 1)
        cat_se = torch.cat([pool_se, cand * 2], 1)
        if merge_kernel and P <= MAX_TOPK:
            pool_d, pool_se = sorted_topk(cat_d, cat_se, P,
                                          presorted=P if dedup_window == 0
                                          else 0)
        else:
            pool_d, pool_se = sorted_topk_plain(cat_d, cat_se, P)
        pool_se = torch.where(pool_d < BIG_THRESH, pool_se, -2)

        # ---- duplicate kill: copies of a slot sit adjacent (equal
        # scores); propagate the expanded flag among equal ids in both
        # directions, then void the later copies ----
        if dedup_window > 0:
            sid = pool_se >> 1
            prop = pool_se & 1
            dup = torch.zeros_like(sid, dtype=torch.bool)
            for w in range(1, min(dedup_window, P - 1) + 1):
                s_r, e_r = _shift(sid, w, -3), _shift(prop, w, 0)
                s_l, e_l = _shift(sid, -w, -3), _shift(prop, -w, 0)
                eq_r = sid == s_r
                prop = prop | (eq_r.int() & e_r) | ((sid == s_l).int() & e_l)
                dup |= eq_r
            pool_se = torch.where(dup, -1, (sid * 2) | prop)
            pool_d = torch.where(dup, big16, pool_d)
        return pool_d, pool_se, res_d, res_s

    carry = (pool_d, pool_se, res_d, res_s)
    if early_exit and schedule is None:
        f = min(F, P)
        for _ in range(T):
            pool_d, pool_se, res_d, _ = carry
            unexp = torch.where(((pool_se & 1) == 1) | ((pool_se >> 1) < 0),
                                BIG, pool_d.float())
            kept = (res_d if res_mask is not None else pool_d).float()
            bound = torch.topk(kept, min(R, kept.shape[1]), dim=1,
                               largest=False, sorted=True).values[:, -1]
            bound = bound.clamp_max(BIG_THRESH)
            if not bool((unexp.min(1).values < bound).any()):
                break
            carry = step(f, *carry)
    else:
        for seg_f, seg_t in (schedule if schedule is not None
                             else ((F, T),)):
            for _ in range(seg_t):
                carry = step(min(seg_f, P), *carry)
    pool_d, pool_se, res_d, res_s = carry

    # ---- exact rerank of the R best pool entries ----
    if res_mask is not None:
        rs = res_s
    else:
        rpos = torch.topk(pool_d.float(), R, dim=1, largest=False,
                          sorted=True).indices
        rs = torch.gather(pool_se >> 1, 1, rpos)
    r_safe = rs.clamp_min(0).long()
    ok = (rs >= 0) & ~later_copies(rs) & has_emb[r_safe]
    if res_mask is not None:
        ok &= res_mask[r_safe]
    # difference form: the expansion's cancellation would break the exact
    # self-match contract
    diff = emb[r_safe] - queries[:, None, :]
    d_ex = torch.where(ok, (diff * diff).sum(-1), BIG)
    out_d, pos = torch.topk(d_ex, k, dim=1, largest=False, sorted=True)
    out_s = torch.where(out_d < BIG_THRESH, torch.gather(rs, 1, pos), -1)
    return out_d, out_s


def beam_search(
    neighbors0: torch.Tensor,   # int32[capacity, W] level-0 adjacency
    aug: torch.Tensor,          # bf16[capacity, dpa] scoring mirror
    emb: torch.Tensor,          # f32[capacity, dim] exact rerank table
    has_emb: torch.Tensor,      # bool[capacity]
    seed_slots: torch.Tensor,   # int32[S], -1 padded
    queries: torch.Tensor,      # f32[B, dim]
    queries_aug: torch.Tensor,  # f32[B, dpa]
    F: int,
    T: int,
    k: int,
    rerank_k: int,
    hist: int = 2,
    dedup_window: int = 8,
    inline_tabs=None,
    res_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pool-free beam traversal: the next frontier is the top F of this
    step's K = F * W candidate scores (ties to the lower position), with no
    ef-wide pool. Every step's frontier is kept (the trajectory, [B, (T + 1)
    F]); one selection over it picks the R = rerank_k best, exactly
    reranked. Revisits are held off by a history of the last ``hist``
    frontiers, and a window dedup voids equal-score copies of one slot
    inside a new frontier. ``inline_tabs`` scores candidates from the int8
    inline blocks, one per frontier node; ``res_mask`` masks the trajectory
    before the selection (navigation stays unfiltered). Returns (d_sq
    f32[B, k], slots int32[B, k]) ascending, (BIG, -1) padded, distances
    exact (difference form)."""
    b = queries.shape[0]
    qa = queries_aug.to(torch.bfloat16).float()

    # ---- seed: score the fixed seed set, take the first frontier ----
    seed_b = seed_slots[None, :].expand(b, seed_slots.shape[0])
    d_seed = torch.where(seed_b >= 0, _aug_scores(aug, seed_b, qa), BIG)
    if d_seed.shape[1] < F:
        pad = F - d_seed.shape[1]
        d_seed = torch.cat([d_seed, d_seed.new_full((b, pad), BIG)], 1)
        seed_b = torch.cat([seed_b, seed_b.new_full((b, pad), -1)], 1)
    fd, fpos = smallest_stable(d_seed, F)
    frontier = torch.where(fd < BIG_THRESH, torch.gather(seed_b, 1, fpos), -1)
    if inline_tabs is not None:
        q_i8, q_scale = _inline_queries(queries_aug, inline_tabs[0].shape[-1])

    seen = torch.full((b, max(hist, 1) * F), -1, dtype=torch.int32,
                      device=queries.device)
    traj_d, traj_s = [], []
    for _ in range(T):
        fvalid = frontier >= 0
        cand = neighbors0[frontier.clamp_min(0).long()]       # [B, F, W]
        cand = torch.where(fvalid[:, :, None], cand, -1).reshape(b, -1)
        if inline_tabs is not None:
            d_new = _inline_scores(inline_tabs, frontier, q_i8, q_scale)
        else:
            d_new = _aug_scores(aug, cand, qa)
        # mask invalid and recently expanded candidates (the history
        # window, the current frontier included: it is already emitted)
        recent = torch.cat([seen[:, F:], frontier], 1) if hist > 1 \
            else frontier
        d_new = torch.where((cand >= 0) & ~_member(cand, recent), d_new, BIG)
        nd, npos = smallest_stable(d_new, F)
        nfront = torch.where(nd < BIG_THRESH, torch.gather(cand, 1, npos), -1)
        # window dedup within the new frontier: copies of one slot (one
        # node reached from two parents) score bit-identically and sit
        # adjacent
        if dedup_window > 0:
            dup = torch.zeros_like(nfront, dtype=torch.bool)
            for w in range(1, min(dedup_window, F - 1) + 1):
                dup |= nfront == _shift(nfront, w, -3)
            nd = torch.where(dup, BIG, nd)
            nfront = torch.where(dup, -1, nfront)
        seen = recent if hist > 1 else frontier
        traj_d.append(fd)
        traj_s.append(frontier)
        frontier, fd = nfront, nd
    ds = torch.cat(traj_d + [fd], 1)
    ss = torch.cat(traj_s + [frontier], 1)

    # ---- one deferred selection + exact rerank ----
    if res_mask is not None:
        ds = torch.where((ss >= 0) & res_mask[ss.clamp_min(0).long()], ds,
                         BIG)
    R = min(max(rerank_k, k), ds.shape[1])
    _, rpos = smallest_stable(ds, R)
    rs = torch.gather(ss, 1, rpos)
    r_safe = rs.clamp_min(0).long()
    ok = (rs >= 0) & ~later_copies(rs) & has_emb[r_safe]
    if res_mask is not None:
        ok &= res_mask[r_safe]
    diff = emb[r_safe] - queries[:, None, :]
    d_ex = torch.where(ok, (diff * diff).sum(-1), BIG)
    out_d, pos = smallest_stable(d_ex, k)
    out_s = torch.where(out_d < BIG_THRESH, torch.gather(rs, 1, pos), -1)
    return out_d, out_s
