"""Sentence-embedding-like vectors, drawn on the device.

The recipe of the port's ``datasets.embedding_like`` (rank-``intrinsic``
mixing plus 0.05 Gaussian noise, each row L2-normalized), kept here so the
yardstick does not move with the program's own generator. It draws from the
same distribution, not the same bytes: the stream is a ``torch.Generator``
on the card.

The mixing matrix is the deployment's, fixed by ``mixture_seed`` (its own
stream), so every run's seed draws rows from the same distribution. The
run's stream draws the corpus rows first, then the query rows, so the
corpus of a seed is the same whatever number of queries a traffic mix asks
for. Queries are held out of the corpus.
"""

from __future__ import annotations

import math

import torch

CHUNK = 131072  # rows a draw at a time: the noise never exists whole


class _Source:
    def __init__(self, dim: int, params: dict, gen, device) -> None:
        intrinsic = int(params.get("intrinsic", 64))
        self.noise = float(params.get("noise", 0.05))
        self.gen = gen
        mg = torch.Generator(device=device)
        mg.manual_seed(int(params.get("mixture_seed", 0)))
        self.mix = torch.randn((intrinsic, dim), generator=mg,
                               device=device) / math.sqrt(intrinsic)

    def rows(self, n: int) -> torch.Tensor:
        """The stream's next ``n`` rows, f32[n, dim]."""
        intrinsic, dim = self.mix.shape
        dev = self.mix.device
        out = torch.empty((n, dim), dtype=torch.float32, device=dev)
        for s in range(0, n, CHUNK):
            c = min(CHUNK, n - s)
            u = torch.randn((c, intrinsic), generator=self.gen, device=dev)
            x = u @ self.mix
            x += self.noise * torch.randn((c, dim), generator=self.gen,
                                          device=dev)
            x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
            out[s:s + c] = x
        return out


def make(dim: int, params: dict, gen: torch.Generator,
         device: torch.device) -> _Source:
    """A source of rows on ``device`` drawn from ``gen``: ``rows(n)`` gives
    the next n. ``params``: ``intrinsic`` (the mixing rank, 64), ``noise``
    (0.05) and ``mixture_seed`` (0)."""
    return _Source(dim, params, gen, device)
