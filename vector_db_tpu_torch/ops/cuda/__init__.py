"""Hand-written CUDA kernels of the port, one wrapper module each.

Every wrapper takes its kernel's plain PyTorch version for a CPU tensor and
launches the kernel for a CUDA tensor, or raises; it never falls back. The
kernels build from ``vector_db_tpu_torch/csrc`` at first launch
(``vector_db_tpu_torch._build``).

The two scans with lists (``l2_topk``, ``adc_topk``) take a per-query floor,
and answer a k past their lists by passes (:func:`by_passes`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from vector_db_tpu_torch.ops.distance import BIG
from vector_db_tpu_torch.ops.topk import smallest_stable



def launch_counts() -> dict:
    """Each kernel wrapper's launches so far in this process, by name (a
    wrapper adds one where it launches its kernel, never on the CPU's plain
    version; ``l2_topk`` splits by the table's dtype)."""
    from vector_db_tpu_torch.ops.cuda.adc_probe import adc_probe_scores
    from vector_db_tpu_torch.ops.cuda.adc_scan import adc_topk
    from vector_db_tpu_torch.ops.cuda.block_min import block_min_scan
    from vector_db_tpu_torch.ops.cuda.block_topm import block_topm_scan
    from vector_db_tpu_torch.ops.cuda.l2_topk import l2_topk
    from vector_db_tpu_torch.ops.cuda.sorted_topk import sorted_topk

    return {"l2_topk": l2_topk.launches - l2_topk.launches_bf16,
            "l2_topk_bf16": l2_topk.launches_bf16,
            "block_min": block_min_scan.launches,
            "block_topm": block_topm_scan.launches,
            "adc_probe": adc_probe_scores.launches,
            "adc_topk": adc_topk.launches,
            "sorted_topk": sorted_topk.launches}

def check_cuda_args(what: str, **args) -> None:
    """Raise unless every ``name=(tensor, dtype(s), shape)`` is a contiguous
    CUDA tensor of that dtype and shape on one device."""
    device = None
    for name, (t, dtypes, shape) in args.items():
        dtypes = dtypes if isinstance(dtypes, tuple) else (dtypes,)
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} is on {t.device}, not CUDA")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if t.dtype not in dtypes:
            raise ValueError(f"{what}: {name} has dtype {t.dtype}, "
                             f"expected one of {dtypes}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def floor_mask(vals: torch.Tensor, rows: torch.Tensor,
               after: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """bool[B, n]: (vals[b, j], rows[j]) after the floor ``after[0][b],
    after[1][b]`` in (value, row) order, each row compared as uint32 (a
    pad's -1 after every row): the rows a floored kernel call may list."""
    fv, fi = after[0][:, None], after[1][:, None].long() & 0xFFFFFFFF
    r = rows.long()[None, :] & 0xFFFFFFFF
    return (vals > fv) | ((vals == fv) & (r > fi))


def merge_after(best_d: torch.Tensor, best_i: torch.Tensor,
                d: torch.Tensor, ids: torch.Tensor, k: int,
                ok: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A plain version's running top-k at a floor: the rows of one tile
    (``ids`` ascending, all after ``best``'s rows) where ``ok``, merged into
    ``best`` in (value, row) order, the lower row first among equal values
    as the kernels keep them, so the next floor leaves no tied row out;
    (BIG, -1) past the rows."""
    d = torch.where(ok, d, BIG)
    cat_i = torch.cat([best_i, ids.expand(d.shape)], 1)
    vals, pos = smallest_stable(torch.cat([best_d, d], 1), k)
    return vals, torch.where(vals >= BIG, -1, torch.gather(cat_i, 1, pos))


def check_after(what: str, after, b: int, device) -> None:
    """Raise unless ``after`` is (f32[b], int32[b]), contiguous, on
    ``device``."""
    if len(after) != 2:
        raise ValueError(f"{what}: after is (values, rows)")
    for t, dtype in zip(after, (torch.float32, torch.int32)):
        if (t.dtype != dtype or tuple(t.shape) != (b,) or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{what}: after must be contiguous "
                             f"(f32[{b}], int32[{b}]) on {device}")


def by_passes(scan, k: int, width: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of a kernel whose lists hold ``width`` entries:
    ceil(k / width) calls ``scan(after)``, the first with ``after=None`` and
    each later one from the last call's final (value, row) pair of every
    query, each giving the next ``width`` pairs ascending; joined and cut
    to k. A final pair that is a pad (BIG, -1) leaves nothing after it, so
    the pads stay pads."""
    vals, rows, after = [], [], None
    for _ in range(-(-k // width)):
        v, i = scan(after)
        vals.append(v)
        rows.append(i)
        after = (v[:, -1].contiguous(), i[:, -1].contiguous())
    return torch.cat(vals, 1)[:, :k], torch.cat(rows, 1)[:, :k]


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
