"""Lloyd's k-means on a torch device (port of vector_db_tpu/ops/kmeans.py).

Semantics are the JAX package's (and scipy ``kmeans2(minit='points')``'s):
'points' init (k distinct rows sampled without replacement), a fixed
iteration count, and an empty cluster keeps its previous centroid.

- The E-step is a true-f32 squared-L2 product (raises if CUDA matmuls may
  use TF32), streamed over row chunks so the ``[N, k]`` matrix never exists
  whole: the IVF build trains 4096 cells on 262,144 rows, where one
  unchunked step would be 4 GiB.
- The M-step sums rows into their centroid with ``index_add_`` in place of
  the JAX one-hot matmul: the same sum, in another order.
- Subspaces (PQ) are a leading batch axis of one batched Lloyd's, as the
  JAX package ``vmap``s.
- Initial rows come from a ``torch.Generator``; ``jax.random`` numbers
  cannot be reproduced, so trained centroids differ between the packages
  while ``_lloyd`` from the same initial centroids agrees.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vector_db_tpu_torch.device import require_f32_matmul
from vector_db_tpu_torch.ops.distance import l2_sq_pairwise

_ELEMS = 1 << 25  # bound on one E-step chunk's [S, rows, k] distances


def nearest(x: torch.Tensor, c: torch.Tensor):
    """(labels int64[S, N], squared distance f32[S, N]) of each row of
    x f32[S, N, d] to its nearest centroid of c f32[S, k, d]."""
    require_f32_matmul(x)
    s, n, _ = x.shape
    k = c.shape[1]
    c_sq = (c * c).sum(-1)[:, None, :]
    chunk = max(1, _ELEMS // (s * k))
    labels, dists = [], []
    for r in range(0, n, chunk):
        xr = x[:, r:r + chunk]
        # ||x||^2 - 2 x.c + ||c||^2 in the JAX package's order
        d = torch.baddbmm((xr * xr).sum(-1, keepdim=True), xr,
                          c.transpose(1, 2), alpha=-2.0)
        d = (d + c_sq).clamp_min(0.0)
        dmin, lab = d.min(-1)
        labels.append(lab)
        dists.append(dmin)
    return torch.cat(labels, 1), torch.cat(dists, 1)


def _lloyd(x: torch.Tensor, init_centroids: torch.Tensor, iters: int):
    """Batched Lloyd's: x f32[S, N, d], init f32[S, k, d] -> (centroids
    f32[S, k, d], labels int32[S, N], inertia f32[S]). An unbatched
    x f32[N, d] with init f32[k, d] gives unbatched results."""
    if x.dim() == 2:
        c, lab, inertia = _lloyd(x[None], init_centroids[None], iters)
        return c[0], lab[0], inertia[0]
    s, n, d = x.shape
    k = init_centroids.shape[1]
    flat_x = x.reshape(s * n, d)
    base = (torch.arange(s, device=x.device) * k)[:, None]
    centroids = init_centroids.clone()
    for _ in range(iters):
        labels, _ = nearest(x, centroids)
        cell = (labels + base).reshape(-1)
        sums = torch.zeros((s * k, d), dtype=x.dtype, device=x.device)
        sums.index_add_(0, cell, flat_x)
        counts = torch.bincount(cell, minlength=s * k).to(x.dtype)
        new = (sums / counts.clamp_min(1.0)[:, None]).reshape(s, k, d)
        # empty cluster: keep the previous centroid (kmeans2 'warn' rule)
        centroids = torch.where(counts.reshape(s, k, 1) > 0, new, centroids)
    labels, dmin = nearest(x, centroids)
    return centroids, labels.int(), dmin.sum(-1)


def kmeans_multi(
    x: torch.Tensor,
    k: int,
    generator: torch.Generator,
    iters: int = 100,
    restarts: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-means over a leading "subspace" axis, best inertia per subspace
    over ``restarts`` runs: x f32[S, N, d] -> (centroids f32[S, k, d],
    labels int32[S, N]). The PQ codebook trainer. ``generator`` (a CPU
    ``torch.Generator``) draws the initial rows."""
    s, n, _ = x.shape
    best = None
    for _ in range(restarts):
        idx = torch.stack([torch.randperm(n, generator=generator)[:k]
                           for _ in range(s)]).to(x.device)
        init = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
        c, lab, inertia = _lloyd(x, init, iters)
        if best is None:
            best = [c, lab, inertia]
            continue
        better = inertia < best[2]
        best[0] = torch.where(better[:, None, None], c, best[0])
        best[1] = torch.where(better[:, None], lab, best[1])
        best[2] = torch.where(better, inertia, best[2])
    return best[0], best[1]


def kmeans(
    x: torch.Tensor,
    k: int,
    generator: torch.Generator,
    iters: int = 100,
    restarts: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means with restarts (best inertia wins): x f32[N, d] ->
    (centroids f32[k, d], labels int32[N])."""
    c, lab = kmeans_multi(x[None], k, generator, iters=iters,
                          restarts=restarts)
    return c[0], lab[0]


def assign_tiled(
    x: torch.Tensor,
    centroids: torch.Tensor,
    tile: int = 65536,
    n_cand: int = 1,
) -> torch.Tensor:
    """Each row's ``n_cand`` nearest centroids, best first: x f32[N, d],
    centroids f32[k, d] -> int32[N, n_cand], ``tile`` rows at a time (the
    E-step of a corpus too large to cluster whole). ``x`` may be a host
    array's tensor on the CPU; each tile moves to the centroids' device."""
    c_sq = (centroids * centroids).sum(-1)
    out = []
    for r in range(0, x.shape[0], tile):
        rows = x[r:r + tile].to(centroids.device)
        d = l2_sq_pairwise(rows, centroids, c_sq)
        out.append(torch.topk(d, n_cand, dim=1, largest=False).indices.int())
    return torch.cat(out) if out else torch.zeros(
        (0, n_cand), dtype=torch.int32, device=centroids.device)
