"""Per-block top-m scan: phase 1 of the two-phase block-select search
(kernel: ``csrc/block_select.cu``).

Replaces the Pallas kernel
``vector_db_tpu/ops/pallas/block_topm.py:block_topm_scan``. For every
128-row corpus block it emits the ``m`` smallest ``xsq_eff - 2 q.x`` and
their global rows, first match on ties. The kernel's source note says what
bounds it on the H100 and what its design does about that.

Dispatch: a CPU tensor takes :func:`block_topm_plain`; a CUDA tensor
launches the kernel or raises. ``block_topm_scan.launches`` counts kernel
launches.
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple

import torch

from vector_db_tpu_torch.ops.cuda import check_cuda_args, stream_of
from vector_db_tpu_torch.ops.distance import BIG, PAD_ROW

BLOCK = 128  # corpus rows per block; the kernel's tile


def block_scores(
    score_q: torch.Tensor, tab: torch.Tensor, xsq_eff: torch.Tensor,
    tile: int = 65536,
) -> Iterator[Tuple[int, torch.Tensor]]:
    """Yield (first block, f32[B, blocks, 128]) score panels of
    ``xsq_eff + (-2 q cast to the table dtype) . x``, ``tile`` rows at a
    time; rows past N score exactly PAD_ROW, like the JAX padding rows."""
    b = score_q.shape[0]
    n = tab.shape[0]
    q = (score_q.float() * -2.0).to(tab.dtype).float()
    for s in range(0, n, tile):
        x = tab[s:s + tile].float()
        d = xsq_eff[None, s:s + tile] + q @ x.T
        pad = (-x.shape[0]) % BLOCK
        if pad:
            d = torch.cat([d, d.new_full((b, pad), PAD_ROW)], dim=1)
        yield s // BLOCK, d.view(b, -1, BLOCK)


def block_topm_plain(
    score_q: torch.Tensor, tab: torch.Tensor, xsq_eff: torch.Tensor, m: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: m rounds of min and FIRST-MATCH
    argmin (the lowest lane attaining the min) per block, the winner then
    masked to BIG."""
    b = score_q.shape[0]
    nb = math.ceil(tab.shape[0] / BLOCK)
    vals = torch.empty((b, nb, m), dtype=torch.float32, device=tab.device)
    rows = torch.empty((b, nb, m), dtype=torch.int32, device=tab.device)
    lane = torch.arange(BLOCK, device=tab.device)
    for b0, d in block_scores(score_q, tab, xsq_eff):
        b1 = b0 + d.shape[1]
        base = torch.arange(b0, b1, device=tab.device)[None, :] * BLOCK
        for j in range(m):
            mv = d.amin(-1)
            mi = torch.where(d == mv[..., None], lane, BLOCK).amin(-1)
            vals[:, b0:b1, j] = mv
            rows[:, b0:b1, j] = (mi + base).int()
            if j + 1 < m:
                d = torch.where(lane == mi[..., None], BIG, d)
    return vals.view(b, nb * m), rows.view(b, nb * m)


def launch_block_select(
    score_q: torch.Tensor, tab: torch.Tensor, xsq_eff: torch.Tensor, m: int,
    with_rows: bool,
) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """Check the arguments and launch ``vdb_block_select`` on CUDA tensors."""
    b, ds = score_q.shape
    n = tab.shape[0]
    check_cuda_args("block_select", score_q=(score_q, torch.float32, (b, ds)),
                    tab=(tab, (torch.float32, torch.bfloat16), (n, ds)),
                    xsq_eff=(xsq_eff, torch.float32, (n,)))
    if not 1 <= m <= BLOCK:
        raise ValueError(f"block_select: need 1 <= m <= {BLOCK}, got m={m}")
    from vector_db_tpu_torch import _build

    lib = _build.lib()
    q = (score_q * -2.0).to(tab.dtype).contiguous()
    width = math.ceil(n / BLOCK) * m
    vals = torch.empty((b, width), dtype=torch.float32, device=tab.device)
    rows = (torch.empty((b, width), dtype=torch.int32, device=tab.device)
            if with_rows else None)
    with torch.cuda.device(tab.device):
        err = lib.vdb_block_select(
            q.data_ptr(), tab.data_ptr(), xsq_eff.data_ptr(), b, n, ds, m,
            int(tab.dtype == torch.bfloat16), vals.data_ptr(),
            rows.data_ptr() if with_rows else None, stream_of(tab))
    _build.check(err, "block_select")
    return vals, rows


def block_topm_scan(
    score_q: torch.Tensor,   # [B, ds] queries in score space
    tab: torch.Tensor,       # bf16|f32[N, ds] mirror table
    xsq_eff: torch.Tensor,   # f32[N] row norms, invalid rows ~2e38
    block: int = BLOCK,
    m: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block top-``m`` of ``xsq_eff - 2 q.x``.

    Returns ``(vals f32[B, NB*m], rows int32[B, NB*m])``, ``NB =
    ceil(N / 128)``; entry ``b_i*m + j`` is the j-th best of block ``b_i``
    and ``rows`` are GLOBAL row indices (an invalid or padding row carries
    a value >= 1e37 and must be masked by the caller). The ``q_sq``
    constant is omitted; the -2 is folded into the query.
    """
    if block != BLOCK:
        raise ValueError(f"block_topm_scan: block must be {BLOCK}")
    if score_q.device.type == "cpu":
        return block_topm_plain(score_q, tab, xsq_eff, m)
    out = launch_block_select(score_q, tab, xsq_eff, m, with_rows=True)
    block_topm_scan.launches += 1
    return out


block_topm_scan.launches = 0
