"""Full-corpus ADC scan with a running top-k (kernel: ``csrc/adc_scan.cu``).

Replaces the Pallas kernel ``vector_db_tpu/ops/pallas/adc_scan.py:adc_topk``.
It is the kernel under ``PQCodec.adc_search`` in the ``"matmul"`` (default)
and ``"pallas"`` modes; both are the same LUT sum, which the TPU ran as a
one-hot MXU contraction. The kernel's source note says what bounds it on
the H100 and what its design does about that.

Dispatch: a CPU tensor takes :func:`adc_topk_plain`; a CUDA tensor launches
the kernel or raises. ``adc_topk.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vector_db_tpu_torch.ops.cuda import check_cuda_args, stream_of
from vector_db_tpu_torch.ops.distance import BIG
from vector_db_tpu_torch.ops.topk import masked_top_k_smallest, merge_top_k

MAX_K = 256        # the per-query lists live in shared memory
MAX_KSUB = 256
_PLAIN_ELEMS = 1 << 25  # bound on the plain version's gathered [B, tile, m]


def adc_topk_plain(
    lut: torch.Tensor,
    codes: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    tile: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version (the JAX package's ``_adc_search``
    gather formulation), ``tile`` code rows at a time, with a running top-k
    merge. Codes are clamped into ``[0, ksub)``, as a JAX gather clamps an
    index out of range. Any k: ids past the valid rows are (BIG, -1)."""
    b, m, ksub = lut.shape
    n = codes.shape[0]
    tile = tile or max(1024, _PLAIN_ELEMS // max(1, b * m))
    lut_flat = lut.reshape(b, m * ksub)
    offs = torch.arange(m, device=lut.device) * ksub
    best_d = torch.full((b, k), BIG, dtype=torch.float32, device=lut.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=lut.device)
    for s in range(0, n, tile):
        idx = codes[s:s + tile].long().clamp(0, ksub - 1) + offs  # [t, m]
        d = lut_flat[:, idx].sum(-1)                      # [b, t]
        ids = torch.arange(s, s + idx.shape[0], dtype=torch.int32,
                           device=lut.device)
        td, ti = masked_top_k_smallest(d, ids, min(k, idx.shape[0]),
                                       valid=valid[None, s:s + tile])
        best_d, best_i = merge_top_k(best_d, best_i, td, ti, k)
    return best_d, best_i


def adc_topk(
    lut: torch.Tensor,      # f32[B, m, ksub] per-query subspace distances
    codes: torch.Tensor,    # uint8|int32[N, m]
    valid: torch.Tensor,    # bool[N]
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k smallest ADC distances ``sum_j lut[b, j, codes[n, j]]`` over the
    valid rows. Returns (f32[B, k], int32[B, k]) ascending, (BIG, -1) padded.
    ``k`` is limited to 256 on every device (the kernel's lists)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"adc_topk supports 1 <= k <= {MAX_K}, got k={k}")
    if lut.device.type == "cpu":
        return adc_topk_plain(lut, codes, valid, k)

    b, m, ksub = lut.shape
    n = codes.shape[0]
    check_cuda_args("adc_topk", lut=(lut, torch.float32, (b, m, ksub)),
                    codes=(codes, (torch.uint8, torch.int32), (n, m)),
                    valid=(valid, torch.bool, (n,)))
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
            raise ValueError(f"adc_topk: one query's LUT (m={m}, ksub={ksub})"
                             " does not fit in shared memory")
        work = torch.empty(max(1, scratch.value), dtype=torch.uint8,
                           device=lut.device)
        part_d = torch.empty((b, splits.value * k), dtype=torch.float32,
                             device=lut.device)
        part_i = torch.empty((b, splits.value * k), dtype=torch.int32,
                             device=lut.device)
        err = lib.vdb_adc_topk(
            lut.data_ptr(), codes.data_ptr(), is_u8, valid.data_ptr(), b, n,
            m, ksub, k, work.data_ptr(), part_d.data_ptr(), part_i.data_ptr(),
            stream_of(lut))
    _build.check(err, "adc_topk")
    adc_topk.launches += 1
    # cross-CTA merge of the per-split lists: a stable sort keeps split
    # order among equal values, so the lower row wins a tie across splits;
    # (BIG, -1) stays the pad
    top_d, pos = torch.sort(part_d, dim=1, stable=True)
    return top_d[:, :k], torch.gather(part_i, 1, pos[:, :k])


adc_topk.launches = 0
