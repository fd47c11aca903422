"""Exact top-``topk`` by key with an int32 payload (kernel:
``csrc/sorted_topk.cu``).

Replaces the Pallas kernel
``vector_db_tpu/ops/pallas/bitonic_merge.py:sorted_topk``, the pool merge of
``wide_search(merge_kernel=True)``. One CTA sorts one row (or one
16,384-wide slice of it) in shared memory; a row wider than 16,384 keys
takes a second launch over the slices' survivors. The order is total (key,
then column), so the output is the stable sort's: equal keys come out
adjacent, in column order. ``presorted`` (a promise that a prefix is
already ascending) is accepted and not needed: the full sort gives the same
output.

Dispatch: a CPU tensor takes :func:`sorted_topk_plain`; a CUDA tensor
launches the kernel or raises. ``sorted_topk.launches`` counts kernel
launches.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from vector_db_tpu_torch.ops.cuda import check_cuda_args, stream_of

MAX_TOPK = 8192     # a slice of MAX_WIDTH keeps at most half of itself
MAX_WIDTH = 16384   # keys per CTA: 128 KiB of (key, column) words


def sorted_topk_plain(d: torch.Tensor, v: torch.Tensor, topk: int,
                      presorted: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: a stable sort of the keys as f32
    along dim 1, the payload gathered, cut to ``topk``; keys keep their
    dtype."""
    _check(d, v, topk, presorted)
    order = torch.sort(d.float(), dim=1, stable=True).indices[:, :topk]
    return torch.gather(d, 1, order), torch.gather(v, 1, order)


def _check(d, v, topk, presorted) -> None:
    if d.dim() != 2 or tuple(v.shape) != tuple(d.shape):
        raise ValueError(f"sorted_topk: keys {tuple(d.shape)} and payload "
                         f"{tuple(v.shape)} must be one [B, n] shape")
    if not 1 <= topk <= d.shape[1]:
        raise ValueError(f"sorted_topk: need 1 <= topk <= n = {d.shape[1]}, "
                         f"got {topk}")
    if presorted < 0:
        raise ValueError(f"sorted_topk: presorted must be >= 0, got "
                         f"{presorted}")


def sorted_topk(
    d: torch.Tensor,     # f32|bf16[B, n] keys
    v: torch.Tensor,     # int32[B, n] payload
    topk: int,
    presorted: int = 0,  # d[:, :presorted] is ascending (not needed)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``topk`` smallest keys of each row, ascending, with their
    payloads: (keys in d's dtype [B, topk], int32[B, topk]). On CUDA
    ``topk`` is limited to 8192."""
    _check(d, v, topk, presorted)
    if d.device.type == "cpu":
        return sorted_topk_plain(d, v, topk, presorted)

    b, n = d.shape
    check_cuda_args("sorted_topk", d=(d, (torch.float32, torch.bfloat16),
                                      (b, n)),
                    v=(v, torch.int32, (b, n)))
    if topk > MAX_TOPK:
        raise ValueError(f"sorted_topk: topk <= {MAX_TOPK} on CUDA, got "
                         f"{topk}")
    from vector_db_tpu_torch import _build

    lib = _build.lib()
    keys, vals, width = d, v, n
    while True:
        # rows wider than one CTA: each slice keeps its top topk, and the
        # survivors (in slice order) go round again
        slice_w = min(width, MAX_WIDTH)
        slices = math.ceil(width / slice_w)
        out_w = (slices - 1) * topk + min(topk, width - (slices - 1) * slice_w)
        out_k = torch.empty((b, out_w), dtype=d.dtype, device=d.device)
        out_v = torch.empty((b, out_w), dtype=torch.int32, device=d.device)
        if b:
            with torch.cuda.device(d.device):
                err = lib.vdb_sorted_topk(
                    keys.data_ptr(), int(d.dtype == torch.bfloat16),
                    vals.data_ptr(), b, width, slice_w, topk,
                    out_k.data_ptr(), out_v.data_ptr(), out_w, stream_of(d))
            _build.check(err, "sorted_topk")
            sorted_topk.launches += 1
        keys, vals, width = out_k, out_v, out_w
        if slices == 1:
            return keys, vals


sorted_topk.launches = 0
