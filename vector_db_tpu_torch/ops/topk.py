"""Masked top-k helpers (port of vector_db_tpu/ops/topk.py).

``torch.topk`` outside any kernel, as the JAX package uses ``lax.top_k``.
Result sets keep the (BIG, -1) padding contract.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vector_db_tpu_torch.ops.distance import BIG


def masked_top_k_smallest(
    dists: torch.Tensor,
    ids: torch.Tensor,
    k: int,
    valid: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k SMALLEST distances with their ids, ascending.

    dists: f32[..., N]; ids: int32[..., N] or int32[N]; valid: bool[..., N].
    Returns (f32[..., k], int32[..., k]); masked-out entries get (BIG, -1).
    """
    if valid is not None:
        dists = torch.where(valid, dists, BIG)
    top_d, pos = torch.topk(dists, k, dim=-1, largest=False, sorted=True)
    top_i = torch.gather(ids.expand(dists.shape), -1, pos)
    top_i = torch.where(top_d >= BIG, -1, top_i)
    return top_d, top_i


def stable_top_k_smallest(d: torch.Tensor, ids: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`masked_top_k_smallest` by a stable sort: the k smallest of
    the last axis ascending, ties in position order (``lax.top_k``'s, lower
    position first), (BIG, -1) at or above BIG. Selections that must equal
    the JAX package's where distances tie use it."""
    top_d, pos = torch.sort(d, dim=-1, stable=True)
    top_d, pos = top_d[..., :k], pos[..., :k]
    top_i = torch.gather(ids.expand(d.shape), -1, pos)
    return top_d, torch.where(top_d >= BIG, -1, top_i)


def smallest_stable(d: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, positions int64) of the k smallest entries of each row (the
    last axis of a 2-D tensor), ascending; equal values keep the lower
    position first, membership included (``lax.top_k``'s order, and what
    the JAX package's ``approx_min_k`` returns on the CPU). ``torch.topk``
    finds them; only where a row holds more copies of its k-th value than
    the list has room for does the choice among them need the positions:
    then, for every row, the lowest positions of those copies fill the
    list."""
    top = torch.topk(d, k, dim=-1, largest=False, sorted=True)
    kth = top.values[:, -1:]
    if bool(((d <= kth).sum(-1) == k).all()):
        pos = torch.sort(top.indices, dim=1).values
    else:
        below = d < kth
        at = d == kth
        need = k - below.sum(-1, keepdim=True)
        take = below | (at & (at.cumsum(-1) <= need))
        pos = torch.nonzero(take)[:, 1].view(d.shape[0], k)
    vals, order = torch.sort(torch.gather(d, 1, pos), dim=1, stable=True)
    return vals, torch.gather(pos, 1, order)


def later_copies(x: torch.Tensor) -> torch.Tensor:
    """bool, x's shape: True at every copy of a value in its row (last
    axis) but the first, in position order."""
    sx, order = torch.sort(x, dim=-1, stable=True)
    dup_sorted = torch.zeros_like(sx, dtype=torch.bool)
    dup_sorted[..., 1:] = sx[..., 1:] == sx[..., :-1]
    return torch.zeros_like(dup_sorted).scatter_(-1, order, dup_sorted)


def merge_top_k(
    d_a: torch.Tensor,
    i_a: torch.Tensor,
    d_b: torch.Tensor,
    i_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two (dists, ids) top-k sets along the last axis into one top-k."""
    return masked_top_k_smallest(
        torch.cat([d_a, d_b], -1), torch.cat([i_a, i_b], -1), k)
