"""Fused exact L2 scan with a running top-k (kernel: ``csrc/l2_topk.cu``).

Replaces the Pallas kernel ``vector_db_tpu/ops/pallas/l2_topk.py:l2_topk``.
It is the kernel under the port's ``exact_search``/``exact_search_tiled``
(f32 table) and ``approx_search_tiled`` (bf16 table, f32 norms). It scores
on tensor cores: bf16 products directly, the f32 table as 3xTF32 from the
split that :func:`split_tf32` gives the queries. The kernel's source note
says what bounds it on the H100 and what its design does about that.

Dispatch: a CPU tensor takes :func:`l2_topk_plain`; a CUDA tensor launches
the kernel or raises. ``l2_topk.launches`` counts kernel launches,
``l2_topk.launches_bf16`` those over a bf16 table.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from vector_db_tpu_torch.ops.cuda import check_cuda_args, stream_of
from vector_db_tpu_torch.ops.distance import BIG, l2_sq_pairwise, squared_norms
from vector_db_tpu_torch.ops.topk import masked_top_k_smallest, merge_top_k

MAX_K = 256
_TILE_ROWS = 128        # the kernel's corpus tile
_CTAS_PER_SM = 2        # target grid: two waves of one resident CTA per SM


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = rna_tf32(x) and lo = rna_tf32(x - hi), bit for
    bit what ``cvt.rna.tf32.f32`` gives for finite f32 values: round to 10
    explicit mantissa bits, ties away from zero (add half of the 13 dropped
    bits to the magnitude, then clear them)."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x.float())
    return hi, rna(x.float() - hi)


def _query_group(b: int, k: int) -> int:
    """The kernel's queries per CTA: its lists ([group, k]) must fit in
    shared memory; a smaller batch takes the smallest group that holds
    it."""
    nq = 128 if k <= 32 else (64 if k <= 64 else 32)
    while nq > 32 and nq // 2 >= b:
        nq //= 2
    return nq


def l2_topk_plain(
    queries: torch.Tensor,
    emb: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    x_sq: torch.Tensor,
    tile: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version, ``tile`` corpus rows at a time,
    so the [B, N] matrix never exists. Same formula per table dtype."""
    b, n = queries.shape[0], emb.shape[0]
    q = queries.float()
    bf16 = emb.dtype == torch.bfloat16
    if bf16:
        q_sq = squared_norms(q)
        qc = q.to(torch.bfloat16).float()
    best_d = torch.full((b, k), BIG, dtype=torch.float32, device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    for s in range(0, n, tile):
        x = emb[s:s + tile].float()
        if bf16:  # bf16 products are exact in f32; the sum is f32
            d = (q_sq[:, None] - 2.0 * (qc @ x.T)
                 + x_sq[None, s:s + tile])
        else:
            d = l2_sq_pairwise(q, x, x_sq[s:s + tile])
        ids = torch.arange(s, s + x.shape[0], dtype=torch.int32,
                           device=q.device)
        td, ti = masked_top_k_smallest(d, ids, min(k, x.shape[0]),
                                       valid=valid[None, s:s + tile])
        best_d, best_i = merge_top_k(best_d, best_i, td, ti, k)
    return best_d, best_i


def l2_topk(
    queries: torch.Tensor,   # f32[B, d]
    emb: torch.Tensor,       # f32|bf16[N, d]
    valid: torch.Tensor,     # bool[N]
    k: int,
    x_sq: torch.Tensor | None = None,   # f32[N]; from emb when None
    tile: int = 65536,       # rows per pass of the plain version
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest squared L2 of each query over the valid rows.

    Returns (f32[B, k], int32[B, k]) ascending, (BIG, -1) padded when fewer
    than k rows are valid. An f32 table gives the exact, clamped distance; a
    bf16 table scores the bf16-cast query against it with ``x_sq`` (pass
    the f32 source's norms) and no clamp. ``k`` is limited to 256.
    """
    if not 1 <= k <= MAX_K:
        raise ValueError(f"l2_topk supports 1 <= k <= {MAX_K}, got k={k}")
    if x_sq is None:
        x_sq = squared_norms(emb.float())
    if queries.device.type == "cpu":
        return l2_topk_plain(queries, emb, valid, k, x_sq, tile)

    b, d = queries.shape
    n = emb.shape[0]
    check_cuda_args("l2_topk", queries=(queries, torch.float32, (b, d)),
                    emb=(emb, (torch.float32, torch.bfloat16), (n, d)),
                    x_sq=(x_sq, torch.float32, (n,)),
                    valid=(valid, torch.bool, (n,)))
    from vector_db_tpu_torch import _build

    lib = _build.lib()
    bf16 = emb.dtype == torch.bfloat16
    if bf16:
        q_hi, q_lo = queries.to(torch.bfloat16).contiguous(), None
    else:
        q_hi, q_lo = split_tf32(queries)
    q_sq = squared_norms(queries).contiguous()
    nq = _query_group(b, k)
    groups = math.ceil(b / nq)
    blocks = max(1, math.ceil(n / _TILE_ROWS))
    sms = torch.cuda.get_device_properties(emb.device).multi_processor_count
    splits = min(blocks, max(1, math.ceil(_CTAS_PER_SM * sms / groups)))
    rows_per_split = math.ceil(blocks / splits) * _TILE_ROWS
    splits = max(1, math.ceil(n / rows_per_split))
    part_d = torch.empty((b, splits * k), dtype=torch.float32,
                         device=emb.device)
    part_i = torch.empty((b, splits * k), dtype=torch.int32,
                         device=emb.device)
    if b:
        with torch.cuda.device(emb.device):
            err = lib.vdb_l2_topk(
                q_hi.data_ptr(), 0 if bf16 else q_lo.data_ptr(),
                emb.data_ptr(), q_sq.data_ptr(), x_sq.data_ptr(),
                valid.data_ptr(), b, n, d, k, nq, rows_per_split, splits,
                int(bf16), part_d.data_ptr(), part_i.data_ptr(),
                stream_of(emb))
        _build.check(err, "l2_topk")
        l2_topk.launches += 1
        l2_topk.launches_bf16 += bf16
    if splits == 1:
        return part_d, part_i
    # cross-CTA merge: split s holds columns [s k, s k + k), ascending by
    # (value, row), and splits ascend by row, so a stable sort by value
    # keeps ties in row order; (BIG, -1) stays the pad
    order = torch.sort(part_d, dim=1, stable=True).indices[:, :k]
    return torch.gather(part_d, 1, order), torch.gather(part_i, 1, order)


l2_topk.launches = 0       # every launch
l2_topk.launches_bf16 = 0  # the launches over a bf16 table
