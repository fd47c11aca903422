"""Benchmark and evaluation datasets (the port's copy of
vector_db_tpu/datasets.py): the TEXMEX file readers and the two synthetic
corpora.

- ``read_fvecs`` / ``read_bvecs`` / ``read_ivecs``: the binary formats
  SIFT1M ships in (each record: int32 dim, then dim values);
- ``load_sift1m``: a real SIFT1M directory when present (``SIFT1M_DIR``);
- ``sift_like``: a synthetic stand-in with SIFT-like structure (anisotropic
  Gaussian clusters, log-normal sizes and scales, non-negative, not
  normalized);
- ``embedding_like``: rank-64 mixing plus noise, L2-normalized, like
  sentence-embedding corpora.

Both generators run in numpy from a seed and give the same bytes as the
JAX package's numpy path, so the two packages index one corpus.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# TEXMEX binary formats
# ---------------------------------------------------------------------------

def read_fvecs(path, count: Optional[int] = None) -> np.ndarray:
    """Read .fvecs: records of (int32 dim, float32[dim])."""
    raw = np.fromfile(path, dtype=np.int32, count=-1)
    if raw.size == 0:
        return np.zeros((0, 0), np.float32)
    dim = int(raw[0])
    rec = dim + 1
    n = raw.size // rec
    if count is not None:
        n = min(n, count)
    mat = raw[: n * rec].reshape(n, rec)[:, 1:]
    return mat.view(np.float32).copy()


def read_ivecs(path, count: Optional[int] = None) -> np.ndarray:
    """Read .ivecs: records of (int32 dim, int32[dim]), e.g. ground-truth
    ids."""
    raw = np.fromfile(path, dtype=np.int32, count=-1)
    if raw.size == 0:
        return np.zeros((0, 0), np.int32)
    dim = int(raw[0])
    rec = dim + 1
    n = raw.size // rec
    if count is not None:
        n = min(n, count)
    return raw[: n * rec].reshape(n, rec)[:, 1:].copy()


def read_bvecs(path, count: Optional[int] = None) -> np.ndarray:
    """Read .bvecs: records of (int32 dim, uint8[dim])."""
    raw = np.fromfile(path, dtype=np.uint8, count=-1)
    if raw.size == 0:
        return np.zeros((0, 0), np.float32)
    dim = int(np.frombuffer(raw[:4], np.int32)[0])
    rec = 4 + dim
    n = raw.size // rec
    if count is not None:
        n = min(n, count)
    mat = raw[: n * rec].reshape(n, rec)[:, 4:]
    return mat.astype(np.float32)


def load_sift1m(
    root: Optional[str] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Load real SIFT1M (base, query, groundtruth) if the files exist.

    Looks in ``root`` or ``$SIFT1M_DIR`` for sift_base.fvecs,
    sift_query.fvecs, sift_groundtruth.ivecs. Returns None when absent
    (callers fall back to :func:`sift_like` and must label results).
    """
    d = Path(root or os.environ.get("SIFT1M_DIR", "/data/sift1m"))
    base_f = d / "sift_base.fvecs"
    query_f = d / "sift_query.fvecs"
    gt_f = d / "sift_groundtruth.ivecs"
    if not (base_f.exists() and query_f.exists()):
        return None
    base = read_fvecs(base_f)
    query = read_fvecs(query_f)
    gt = read_ivecs(gt_f) if gt_f.exists() else np.zeros((0, 0), np.int32)
    return base, query, gt


# ---------------------------------------------------------------------------
# synthetic corpora
# ---------------------------------------------------------------------------

def embedding_like(
    n: int, dim: int, seed: int, intrinsic: int = 64,
    device: str = "auto",
) -> np.ndarray:
    """Sentence-embedding-like vectors: rank-``intrinsic`` mixing + noise,
    L2-normalized (MiniLM-style embedding geometry).

    Always generated in numpy (``device="auto"`` or ``"numpy"``), so the
    corpus is bit-identical for a given seed. ``device="jax"`` (the JAX
    package's accelerator generator, a different bit stream) raises.
    """
    if device == "jax":
        raise ValueError(
            "embedding_like(device='jax') is the JAX package's accelerator "
            "generator; the port generates in numpy ('auto' or 'numpy')")
    if device not in ("auto", "numpy"):
        raise ValueError(f"unknown device {device!r}")
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, intrinsic)).astype(np.float32)
    v = rng.standard_normal((intrinsic, dim)).astype(np.float32)
    v /= np.sqrt(intrinsic)
    x = u @ v + 0.05 * rng.standard_normal((n, dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def sift_like(
    n: int,
    dim: int = 128,
    seed: int = 0,
    n_clusters: int = 1024,
    queries: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """SIFT-shaped synthetic corpus: anisotropic Gaussian mixture.

    Strong cluster structure (local intrinsic dimension ~10-15 despite
    ambient 128), log-normal cluster populations, per-cluster anisotropic
    spread, non-negative values, unnormalized norms.

    Returns (base f32[n, dim], queries f32[queries, dim]); queries are drawn
    from the same mixture (held out of the base).
    """
    rng = np.random.default_rng(seed)
    total = n + queries
    centers = rng.gamma(2.0, 24.0, size=(n_clusters, dim)).astype(np.float32)
    # log-normal cluster sizes
    weights = rng.lognormal(0.0, 1.0, size=n_clusters)
    weights /= weights.sum()
    assign = rng.choice(n_clusters, size=total, p=weights)
    # per-cluster anisotropy: a few dominant directions + isotropic floor
    k_dir = 12
    dirs = rng.standard_normal((n_clusters, k_dir, dim)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=2, keepdims=True)
    scales = rng.lognormal(2.2, 0.4, size=(n_clusters, 1)).astype(np.float32)

    coef = rng.standard_normal((total, k_dir)).astype(np.float32)
    x = centers[assign]
    x += scales[assign] * np.einsum("tk,tkd->td", coef, dirs[assign])
    x += 4.0 * rng.standard_normal((total, dim)).astype(np.float32)
    x = np.maximum(x, 0.0)  # SIFT descriptors are non-negative histograms
    x = x.astype(np.float32)
    return x[:n], x[n:]
