"""ADC scores of each query's gathered IVF-PQ candidates (kernel:
``csrc/adc_probe.cu``).

Replaces the Pallas kernel
``vector_db_tpu/ops/pallas/adc_probe.py:adc_probe_scores``, the default
probe scoring of ``IvfIndex.search_batch(pq=True)``. The codes come in the
layout the cell gather produces, uint8 ``[B, P, m]``; the Mosaic kernel's
transposed int32 ``[B, m, P]`` copy and its tile padding of ``P`` are TPU
constraints and are not carried over. The sum is the exact f32 LUT sum in
subspace order (the TPU kernel's hi/lo bf16 LUT pair is an MXU workaround).

Dispatch: a CPU tensor takes :func:`adc_probe_plain`; a CUDA tensor
launches the kernel or raises. ``adc_probe_scores.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from vector_db_tpu_torch.ops.cuda import check_cuda_args, stream_of
from vector_db_tpu_torch.ops.distance import BIG

MAX_KSUB = 256     # codes are bytes
_MAX_B = 65535     # the kernel's grid.y


def adc_probe_plain(lut: torch.Tensor, codes: torch.Tensor,
                    corr: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: a flat-LUT gather and an f32 sum
    over the subspaces (the JAX package's ``adc="gather"`` formulation).
    A code at or above ``ksub`` reads entry ``ksub - 1``, as a JAX gather
    clamps an index out of range."""
    b, m, ksub = lut.shape
    p = codes.shape[1]
    offs = torch.arange(m, device=lut.device) * ksub
    idx = (codes.long().clamp_max(ksub - 1) + offs).reshape(b, p * m)
    d = torch.gather(lut.reshape(b, m * ksub), 1, idx).reshape(b, p, m)
    return torch.where(valid, d.sum(-1) + corr, BIG)


def adc_probe_scores(
    lut: torch.Tensor,     # f32[B, m, ksub] per-query subspace distances
    codes: torch.Tensor,   # uint8[B, P, m] gathered candidate codes
    corr: torch.Tensor,    # f32[B, P] additive correction (residual terms)
    valid: torch.Tensor,   # bool[B, P]
) -> torch.Tensor:
    """ADC distances of per-query gathered candidates: f32[B, P], invalid
    candidates at BIG."""
    if lut.device.type == "cpu":
        return adc_probe_plain(lut, codes, corr, valid)

    b, m, ksub = lut.shape
    p = codes.shape[1]
    check_cuda_args("adc_probe_scores", lut=(lut, torch.float32, (b, m, ksub)),
                    codes=(codes, torch.uint8, (b, p, m)),
                    corr=(corr, torch.float32, (b, p)),
                    valid=(valid, torch.bool, (b, p)))
    if not 1 <= ksub <= MAX_KSUB:
        raise ValueError(f"adc_probe_scores: ksub must be in 1..{MAX_KSUB}, "
                         f"got {ksub}")
    if b > _MAX_B:
        raise ValueError(f"adc_probe_scores: at most {_MAX_B} queries per "
                         f"call, got {b}")
    out = torch.empty((b, p), dtype=torch.float32, device=lut.device)
    if out.numel() == 0:
        return out
    from vector_db_tpu_torch import _build

    lib = _build.lib()
    with torch.cuda.device(lut.device):
        err = lib.vdb_adc_probe(lut.data_ptr(), codes.data_ptr(),
                                corr.data_ptr(), valid.data_ptr(), b, p, m,
                                ksub, out.data_ptr(), stream_of(lut))
    _build.check(err, "adc_probe_scores")
    adc_probe_scores.launches += 1
    return out


adc_probe_scores.launches = 0
