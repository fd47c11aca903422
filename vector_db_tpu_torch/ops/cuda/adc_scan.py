"""Full-corpus ADC scan with a running top-k (kernel: ``csrc/adc_scan.cu``).

Replaces the Pallas kernel ``vector_db_tpu/ops/pallas/adc_scan.py:adc_topk``.
It is the kernel under ``PQCodec.adc_search`` in the ``"matmul"`` (default)
and ``"pallas"`` modes; both are the same LUT sum, which the TPU ran as a
one-hot MXU contraction. Two optional additive terms, ``row_bias[n]`` and
``group_bias[b, n // group]``, carry the full-scan residual IVF-PQ
(``IvfIndex.search_batch`` at ``n_probe >= k``): the stored residual scalar
of each padded cell slot and the (query, cell) coarse term, whose one-hot
MXU contraction in the JAX package is the same LUT sum. The kernel's source
note says what bounds it on the H100 and what its design does about that.

Dispatch: a CPU tensor takes :func:`adc_topk_plain`; a CUDA tensor launches
the kernel or raises. ``adc_topk.launches`` counts kernel launches. One
launch lists up to 2048 per query; :func:`adc_topk_long` answers any k, on a
CUDA tensor by passes of the kernel, each from a per-query floor
(``after``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vector_db_tpu_torch.ops.cuda import (
    by_passes,
    check_after,
    check_cuda_args,
    floor_mask,
    merge_after,
    stream_of,
)
from vector_db_tpu_torch.ops.distance import BIG
from vector_db_tpu_torch.ops.topk import masked_top_k_smallest, merge_top_k

MAX_K = 2048       # the per-query lists live in shared memory
MAX_KSUB = 256
_PLAIN_ELEMS = 1 << 25  # bound on the plain version's gathered [B, tile, m]


def _check_bias(b, n, row_bias, group_bias, group) -> None:
    if row_bias is not None and tuple(row_bias.shape) != (n,):
        raise ValueError(f"adc_topk: row_bias has shape "
                         f"{tuple(row_bias.shape)}, expected ({n},)")
    if group_bias is not None:
        if group < 1:
            raise ValueError(f"adc_topk: group must be >= 1, got {group}")
        want = (b, -(-n // group))
        if tuple(group_bias.shape) != want:
            raise ValueError(f"adc_topk: group_bias has shape "
                             f"{tuple(group_bias.shape)}, expected {want}")


def adc_topk_plain(
    lut: torch.Tensor,
    codes: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    tile: int | None = None,
    row_bias: torch.Tensor | None = None,
    group_bias: torch.Tensor | None = None,
    group: int = 1,
    after: Tuple[torch.Tensor, torch.Tensor] | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version (the JAX package's ``_adc_search``
    gather formulation), ``tile`` code rows at a time, with a running top-k
    merge. Codes are clamped into ``[0, ksub)``, as a JAX gather clamps an
    index out of range. A row's value is the LUT sum, plus ``row_bias[n]``,
    plus ``group_bias[b, n // group]``, in that order. Any k: ids past the
    valid rows are (BIG, -1). With ``after``, only the rows past each
    query's floor, in (value, row) order as the kernel lists them."""
    b, m, ksub = lut.shape
    n = codes.shape[0]
    _check_bias(b, n, row_bias, group_bias, group)
    tile = tile or max(1024, _PLAIN_ELEMS // max(1, b * m))
    lut_flat = lut.reshape(b, m * ksub)
    offs = torch.arange(m, device=lut.device) * ksub
    best_d = torch.full((b, k), BIG, dtype=torch.float32, device=lut.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=lut.device)
    for s in range(0, n, tile):
        idx = codes[s:s + tile].long().clamp(0, ksub - 1) + offs  # [t, m]
        d = lut_flat[:, idx].sum(-1)                      # [b, t]
        rows = torch.arange(s, s + idx.shape[0], device=lut.device)
        if row_bias is not None:
            d = d + row_bias[s:s + idx.shape[0]]
        if group_bias is not None:
            d = d + group_bias[:, rows // group]
        ids = rows.int()
        if after is not None:
            best_d, best_i = merge_after(
                best_d, best_i, d, ids, k,
                valid[None, s:s + tile] & floor_mask(d, ids, after))
            continue
        td, ti = masked_top_k_smallest(d, ids, min(k, idx.shape[0]),
                                       valid=valid[None, s:s + tile])
        best_d, best_i = merge_top_k(best_d, best_i, td, ti, k)
    return best_d, best_i


def adc_topk(
    lut: torch.Tensor,      # f32[B, m, ksub] per-query subspace distances
    codes: torch.Tensor,    # uint8|int32[N, m]
    valid: torch.Tensor,    # bool[N]
    k: int,
    row_bias: torch.Tensor | None = None,    # f32[N]
    group_bias: torch.Tensor | None = None,  # f32[B, ceil(N / group)]
    group: int = 1,
    after: Tuple[torch.Tensor, torch.Tensor] | None = None,  # f32/int32[B]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest ADC distances ``sum_j lut[b, j, codes[n, j]]`` (plus
    ``row_bias[n]`` and ``group_bias[b, n // group]`` where given) over the
    valid rows. Returns (f32[B, k], int32[B, k]) ascending, (BIG, -1)
    padded. ``k`` is limited to :data:`MAX_K` (2048) on every device: the
    kernel keeps each query's list beside its LUT in shared memory, and a
    CTA holds fewer queries as k grows (2 at m = 16, ksub = 256, k = 2048);
    a shape whose LUT and lists do not fit even for one query raises
    (:func:`adc_topk_long` takes any k). ``after`` (values, rows) lists
    only the rows past each query's pair in (value, row) order."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"adc_topk supports 1 <= k <= {MAX_K}, got k={k}")
    if lut.device.type == "cpu":
        return adc_topk_plain(lut, codes, valid, k, row_bias=row_bias,
                              group_bias=group_bias, group=group,
                              after=after)

    b, m, ksub = lut.shape
    n = codes.shape[0]
    _check_bias(b, n, row_bias, group_bias, group)
    bias = {}
    if row_bias is not None:
        bias["row_bias"] = (row_bias, torch.float32, (n,))
    if group_bias is not None:
        bias["group_bias"] = (group_bias, torch.float32,
                              tuple(group_bias.shape))
    check_cuda_args("adc_topk", lut=(lut, torch.float32, (b, m, ksub)),
                    codes=(codes, (torch.uint8, torch.int32), (n, m)),
                    valid=(valid, torch.bool, (n,)), **bias)
    if after is not None:
        check_after("adc_topk", after, b, lut.device)
    if not 1 <= ksub <= MAX_KSUB:
        raise ValueError(f"adc_topk: ksub must be in 1..{MAX_KSUB}, got {ksub}")
    if n == 0 or b == 0:  # all pads, nothing to launch
        return (torch.full((b, k), BIG, device=lut.device),
                torch.full((b, k), -1, dtype=torch.int32, device=lut.device))
    from vector_db_tpu_torch import _build

    lib = _build.lib()
    is_u8 = int(codes.dtype == torch.uint8)
    # the kernel picks its layout and corpus splits; int32 codes, uint8
    # codes that need a clamp or are off the bulk copies' alignment, and a
    # mask off it, go through a scratch it asks for
    splits, scratch = ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(lut.device):
        _build.check(lib.vdb_adc_topk_plan(
            b, n, m, ksub, k, codes.data_ptr(), is_u8, valid.data_ptr(),
            ctypes.byref(splits), ctypes.byref(scratch)), "adc_topk")
        if splits.value == 0:
            raise ValueError(f"adc_topk: one query's LUT and list (m={m}, "
                             f"ksub={ksub}, k={k}) do not fit in shared "
                             "memory")
        work = torch.empty(max(1, scratch.value), dtype=torch.uint8,
                           device=lut.device)
        part_d = torch.empty((b, splits.value * k), dtype=torch.float32,
                             device=lut.device)
        part_i = torch.empty((b, splits.value * k), dtype=torch.int32,
                             device=lut.device)
        err = lib.vdb_adc_topk(
            lut.data_ptr(), codes.data_ptr(), is_u8, valid.data_ptr(),
            None if row_bias is None else row_bias.data_ptr(),
            None if group_bias is None else group_bias.data_ptr(),
            max(1, int(group)),
            None if after is None else after[0].data_ptr(),
            None if after is None else after[1].data_ptr(),
            b, n, m, ksub, k, work.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(), stream_of(lut))
    _build.check(err, "adc_topk")
    adc_topk.launches += 1
    # cross-CTA merge of the per-split lists: a stable sort keeps split
    # order among equal values, so the lower row wins a tie across splits;
    # (BIG, -1) stays the pad
    top_d, pos = torch.sort(part_d, dim=1, stable=True)
    return top_d[:, :k], torch.gather(part_i, 1, pos[:, :k])


def adc_topk_long(
    lut: torch.Tensor,
    codes: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    row_bias: torch.Tensor | None = None,
    group_bias: torch.Tensor | None = None,
    group: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`adc_topk` for any k >= 1. Up to 2048 it is one launch. Past
    it, a CUDA tensor takes ceil(k / 2048) launches of k = 2048, each after
    the last one's final (value, row) pair (:func:`by_passes`): the same
    plan every time, so a value is the same bits in every pass and the
    passes join into the exact top-k. A CPU tensor takes the plain version
    at k."""
    if k < 1:
        raise ValueError(f"adc_topk supports k >= 1, got k={k}")
    kw = dict(row_bias=row_bias, group_bias=group_bias, group=group)
    if k <= MAX_K:
        return adc_topk(lut, codes, valid, k, **kw)
    if lut.device.type == "cpu":
        return adc_topk_plain(lut, codes, valid, k, **kw)
    return by_passes(lambda after: adc_topk(lut, codes, valid, MAX_K,
                                            after=after, **kw), k, MAX_K)


adc_topk.launches = 0
