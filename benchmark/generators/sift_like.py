"""SIFT-shaped vectors, drawn on the device.

The recipe of the port's ``datasets.sift_like``: an anisotropic Gaussian
mixture of ``clusters`` centres (Gamma(2, 24) entries) with log-normal
cluster weights, per cluster ``directions`` unit directions scaled by a
log-normal spread, an isotropic floor of ``floor`` standard deviations, and
the result clipped at 0 (SIFT descriptors are non-negative histograms). It
draws from the same distribution as the port's generator, not the same
bytes: the stream is a ``torch.Generator`` on the card.

The mixture's parameters are the deployment's, fixed by ``mixture_seed``
(its own stream), so every run's seed draws rows from the same mixture:
the same cluster sizes and spreads, and so the same work, in another
sample. The run's stream draws the corpus rows, then the query rows (held
out of the corpus).
"""

from __future__ import annotations

import torch

CHUNK = 65536  # rows a draw at a time: [CHUNK, directions, dim] f32


def _gamma2(shape, scale: float, gen, device) -> torch.Tensor:
    """Gamma(2, scale): the sum of two unit exponentials, scaled."""
    u = torch.rand((2, *shape), generator=gen, device=device)
    return -scale * torch.log1p(-u).sum(0)


def _lognormal(shape, mean: float, sigma: float, gen, device):
    return torch.exp(mean + sigma * torch.randn(shape, generator=gen,
                                                device=device))


class _Mixture:
    def __init__(self, dim: int, params: dict, gen, device) -> None:
        c = int(params.get("clusters", 1024))
        k = int(params.get("directions", 12))
        self.floor = float(params.get("floor", 4.0))
        self.gen, self.device, self.dim = gen, device, dim
        mg = torch.Generator(device=device)
        mg.manual_seed(int(params.get("mixture_seed", 0)))
        self.centers = _gamma2((c, dim), 24.0, mg, device)
        w = _lognormal((c,), 0.0, 1.0, mg, device).double()
        self.cdf = torch.cumsum(w / w.sum(), 0)
        dirs = torch.randn((c, k, dim), generator=mg, device=device)
        self.dirs = dirs / torch.linalg.vector_norm(dirs, dim=2, keepdim=True)
        self.scales = _lognormal((c, 1), 2.2, 0.4, mg, device)

    def rows(self, n: int) -> torch.Tensor:
        """The stream's next ``n`` rows, f32[n, dim]."""
        g, dev = self.gen, self.device
        out = torch.empty((n, self.dim), dtype=torch.float32, device=dev)
        k = self.dirs.shape[1]
        for s in range(0, n, CHUNK):
            c = min(CHUNK, n - s)
            u = torch.rand((c,), generator=g, device=dev, dtype=torch.float64)
            a = torch.searchsorted(self.cdf, u).clamp_max(
                self.cdf.shape[0] - 1)
            coef = torch.randn((c, 1, k), generator=g, device=dev)
            x = self.centers[a] + self.scales[a] * torch.bmm(
                coef, self.dirs[a])[:, 0]
            x += self.floor * torch.randn((c, self.dim), generator=g,
                                          device=dev)
            out[s:s + c] = x.clamp_min_(0.0)
        return out


def make(dim: int, params: dict, gen: torch.Generator,
         device: torch.device) -> _Mixture:
    """A source of rows on ``device`` drawn from ``gen``: ``rows(n)`` gives
    the next n. ``params``: ``clusters`` (1024), ``directions`` (12),
    ``floor`` (4.0), ``mixture_seed`` (0)."""
    return _Mixture(dim, params, gen, device)
