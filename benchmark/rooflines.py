"""The chip's peaks and the operations and bytes of the kernels the
benchmark holds to their roofline.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the full
700 W power limit. A share of the roofline is the least time the chip could
take for the work (the larger of bytes over the memory rate and operations
over the peak rate of their type) over the time the kernel took. Each input
byte counts once and each output byte once, whatever the kernel reads again;
rows count only where they hold a vector (the table's capacity padding does
not).
"""

from __future__ import annotations

from typing import Tuple

HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12


def bound_s(nbytes: float, ops: float, peak_ops: float) -> float:
    """Seconds the chip needs at least: bytes at the memory rate or
    operations at ``peak_ops``, whichever is longer."""
    return max(nbytes / HBM_BYTES_S, ops / peak_ops)


def adc_topk(b: int, rows: int, m: int, ksub: int, k: int, groups: int
             ) -> Tuple[float, float, float]:
    """(bytes, operations, peak) of one ``adc_topk`` scan with a row term
    and a (query, group) term, as the IVF-PQ full scan calls it: the
    ``rows`` live rows' uint8 codes, validity bytes and f32 row terms, the
    f32 group terms of ``groups`` cells a query, the f32 lookup tables of
    ``m`` subspaces of ``ksub`` entries, ``k`` (value, row) pairs out a
    query; one f32 add per (query, row, subspace) and two more per (query,
    row) for the terms."""
    nbytes = (rows * (m + 1 + 4) + b * groups * 4 + b * m * ksub * 4
              + b * k * 8)
    return nbytes, float(b) * rows * (m + 2), F32_FLOPS
