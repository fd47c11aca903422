"""Mirror scores of gathered rows, the wide beam's candidate scoring (kernel:
``csrc/mirror_scores.cu``).

Replaces no Pallas kernel: the JAX package scores these rows with an
XLA-fused ``jnp.einsum`` over the gathered rows
(``vector_db_tpu/index/wide_beam.py:285``). The kernel reads each gathered
bf16 row once and writes only the f32 score, where the plain chain writes
and reads every row again for the widening, the product and each level of
the sum.

The score of row ``aug[idx[b, j]]`` against ``qa[b]`` is a product and a
pairwise sum in an order fixed by the width alone (:func:`_fixed_sum`, f32
operations with no fused multiply-add), so one row gets the same bits in
any batch or chunk shape, on the card and on the CPU: the kernel's output
equals :func:`mirror_scores_plain`'s bit for bit. An id of -1 scores row 0;
callers mask it.

Dispatch: a CPU tensor takes :func:`mirror_scores_plain`; a CUDA tensor
launches the kernel or raises. ``mirror_scores.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from vector_db_tpu_torch.ops.cuda import (
    check_args,
    check_cuda_args,
    stream_of,
)

SCORE_ELEMS = 1 << 28   # bound on one plain scoring chunk's [B, rows, dpa] f32


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


def mirror_scores_plain(aug: torch.Tensor, idx: torch.Tensor,
                        qa: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version: mirror scores f32[B, K] of rows
    ``aug[idx]`` (idx [B, K]; -1 scores row 0, callers mask it) against
    ``qa`` f32[B, dpa]: widened bf16 values times ``qa``, summed by
    :func:`_fixed_sum`. The candidate axis runs in pieces of at most
    ``SCORE_ELEMS`` f32 elements."""
    b, k = idx.shape
    dpa = aug.shape[1]
    step = max(1, SCORE_ELEMS // max(1, b * dpa))
    out = torch.empty((b, k), dtype=torch.float32, device=aug.device)
    for s in range(0, k, step):
        rows = aug[idx[:, s:s + step].clamp_min(0).long()].float()
        rows.mul_(qa[:, None, :])
        out[:, s:s + step] = _fixed_sum(rows)
    return out


def mirror_scores(
    aug: torch.Tensor,   # bf16[N, dpa] scoring mirror
    idx: torch.Tensor,   # int32[B, K] rows; -1 scores row 0
    qa: torch.Tensor,    # f32[B, dpa] queries
) -> torch.Tensor:
    """Mirror scores f32[B, K], bit-identical on every device; on CUDA one
    launch covers the whole call. ``idx``'s rows may lie at any row stride
    (0: one row of ids broadcast over the batch, the wide beam's seed set),
    so only a row need be contiguous."""
    for name, x in (("aug", aug), ("idx", idx), ("qa", qa)):
        if x.dim() != 2:
            raise ValueError(f"mirror_scores: {name} has shape "
                             f"{tuple(x.shape)}, expected two dimensions")
    (n, dpa), (b, k) = aug.shape, idx.shape
    if n == 0 and idx.numel():
        raise ValueError("mirror_scores: aug has no rows")
    row = idx[:1]   # contiguous iff idx's rows are
    (check_args if aug.device.type == "cpu" else check_cuda_args)(
        "mirror_scores", aug=(aug, torch.bfloat16, (n, dpa)),
        idx=(row, torch.int32, (min(b, 1), k)),
        qa=(qa, torch.float32, (b, dpa)))
    if aug.device.type == "cpu":
        return mirror_scores_plain(aug, idx, qa)
    from vector_db_tpu_torch import _build

    out = torch.empty((b, k), dtype=torch.float32, device=aug.device)
    if b and k:
        lib = _build.lib()
        with torch.cuda.device(aug.device):
            err = lib.vdb_mirror_scores(
                aug.data_ptr(), n, dpa, idx.data_ptr(),
                idx.stride(0) if b > 1 else 0, qa.data_ptr(), b, k,
                out.data_ptr(), stream_of(aug))
        _build.check(err, "mirror_scores")
        mirror_scores.launches += 1
    return out


mirror_scores.launches = 0
