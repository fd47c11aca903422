"""Per-block minimum scan: phase 1 of the three-phase block-select search
(kernel: ``csrc/block_select.cu``, its m = 1 form without rows).

Replaces the Pallas kernel
``vector_db_tpu/ops/pallas/block_min.py:block_min_scan``. The kernel's
source note says what bounds it on the H100 and what its design does about
that.

Dispatch: a CPU tensor takes :func:`block_min_plain`; a CUDA tensor
launches the kernel or raises. ``block_min_scan.launches`` counts kernel
launches.
"""

from __future__ import annotations

import math

import torch

from vector_db_tpu_torch.ops.cuda.block_topm import (
    BLOCK,
    block_scores,
    launch_block_select,
)


def block_min_plain(
    score_q: torch.Tensor, tab: torch.Tensor, xsq_eff: torch.Tensor,
) -> torch.Tensor:
    """The kernel's plain PyTorch version."""
    nb = math.ceil(tab.shape[0] / BLOCK)
    out = torch.empty((score_q.shape[0], nb), dtype=torch.float32,
                      device=tab.device)
    for b0, d in block_scores(score_q, tab, xsq_eff):
        out[:, b0:b0 + d.shape[1]] = d.amin(-1)
    return out


def block_min_scan(
    score_q: torch.Tensor,   # [B, ds] queries in score space
    tab: torch.Tensor,       # bf16|f32[N, ds] mirror table
    xsq_eff: torch.Tensor,   # f32[N] row norms, invalid rows ~2e38
    block: int = BLOCK,
) -> torch.Tensor:
    """Per-block minima of ``xsq_eff - 2 q.x``: f32[B, ceil(N / 128)].
    The ``q_sq`` constant is omitted; the -2 is folded into the query."""
    if block != BLOCK:
        raise ValueError(f"block_min_scan: block must be {BLOCK}")
    if score_q.device.type == "cpu":
        return block_min_plain(score_q, tab, xsq_eff)
    vals, _ = launch_block_select(score_q, tab, xsq_eff, 1, with_rows=False)
    block_min_scan.launches += 1
    return vals


block_min_scan.launches = 0
