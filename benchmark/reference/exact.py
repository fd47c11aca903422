"""The plain reference: exact L2 nearest neighbours in plain PyTorch.

It knows nothing of the program under test. It reads the benchmark's own
copy of the corpus and the queries the benchmark handed the program, and
works out from them:

- ``topk``: the exact top-k by squared L2 of every query over the corpus,
  or over the rows of an allow-list, in float32 with TF32 off (the control
  passes ``dtype=torch.bfloat16``: the same scan computed in bfloat16);
- ``pair_distances``: the L2 distance of given (query, row) pairs, in
  float64 from the differences, so it carries no cancellation of its own.

Both work in blocks of queries and corpus rows so the [B, N] matrix never
exists whole.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

BLOCK_BYTES = 1 << 32   # the largest [queries, rows] block of distances
PAIR_BLOCK = 1 << 17    # (query, row) pairs a pass of pair_distances


@contextlib.contextmanager
def _no_tf32():
    """float32 products in true float32 on the card, whatever the caller
    set."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _merge(best_d, best_i, d, ids, k):
    cat_d = torch.cat([best_d, d], 1)
    cat_i = torch.cat([best_i, ids], 1)
    top_d, pos = torch.topk(cat_d, k, dim=1, largest=False, sorted=True)
    return top_d, torch.gather(cat_i, 1, pos)


def topk(corpus: torch.Tensor, queries: torch.Tensor, k: int,
         allow: Optional[torch.Tensor] = None,
         dtype: torch.dtype = torch.float32,
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-``k`` smallest L2 of each query over ``corpus`` f32[N, d]
    (or over its rows ``allow`` int64[A]): (L2 distances [B, k] in
    ``dtype``, ascending, as float32; row ids int64[B, k]). The squared
    distance is ||x||^2 - 2 q.x, ranked, then plus ||q||^2, every term in
    ``dtype``."""
    device = corpus.device
    q = queries.to(device=device, dtype=dtype)
    rows = corpus if allow is None else corpus[allow]
    n, b = rows.shape[0], q.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds the {n} rows to search")
    per = max(1, BLOCK_BYTES // (4 * n))            # queries a block
    tile = max(k, min(n, BLOCK_BYTES // (4 * min(b, per))))
    out_d, out_i = [], []
    with _no_tf32():
        tiles = []
        for r in range(0, n, tile):
            x = rows[r:r + tile].to(dtype)
            tiles.append((r, x, (x * x).sum(1)))
        for s in range(0, b, per):
            qb = q[s:s + per]
            best_d = torch.zeros((qb.shape[0], 0), dtype=dtype, device=device)
            best_i = torch.zeros((qb.shape[0], 0), dtype=torch.int64,
                                 device=device)
            for r, x, x_sq in tiles:
                d = torch.addmm(x_sq[None, :], qb, x.T, alpha=-2.0)
                tk = min(k, x.shape[0])
                td, ti = torch.topk(d, tk, dim=1, largest=False, sorted=True)
                best_d, best_i = _merge(best_d, best_i, td, ti + r,
                                        min(k, best_d.shape[1] + tk))
            out_d.append(best_d + (qb * qb).sum(1)[:, None])
            out_i.append(best_i)
    d = torch.cat(out_d).clamp_min(0).sqrt().float()
    i = torch.cat(out_i)
    if allow is not None:
        i = allow[i]
    return d, i


def pair_distances(corpus: torch.Tensor, queries: torch.Tensor,
                   rows: torch.Tensor) -> torch.Tensor:
    """float64[B, K]: the L2 distance of query b to row ``rows[b, j]`` of
    ``corpus``, from the float64 differences. ``rows`` int64[B, K], every
    entry a row of the corpus."""
    device = corpus.device
    b, kk = rows.shape
    out = torch.empty((b, kk), dtype=torch.float64, device=device)
    per = max(1, PAIR_BLOCK // max(kk, 1))
    for s in range(0, b, per):
        q = queries[s:s + per].to(device=device, dtype=torch.float64)
        x = corpus[rows[s:s + per].to(device)].double()
        out[s:s + per] = torch.linalg.vector_norm(x - q[:, None, :], dim=2)
    return out
