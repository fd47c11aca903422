"""Product quantization: codebook training, encode/decode and ADC scoring on
a torch device (port of vector_db_tpu/index/pq.py).

Same API and validation as the JAX package: ``PQCodec`` (train once with
optional OPQ, encode many), ``ProductQuantizationService.compress``, and
ADC search. Differences:

- every product that feeds a distance is true f32: the ADC LUT is an
  elementwise f32 difference (the JAX ``_adc_lut`` runs at
  ``Precision.HIGHEST`` because LUT errors add up m-fold), OPQ's rotation
  and the encoder's E-step raise if CUDA matmuls may use TF32;
- ``adc_search`` modes ``"matmul"`` (default) and ``"pallas"`` both run the
  ``adc_topk`` kernel on CUDA tensors: the TPU's one-hot MXU matmul and its
  Pallas kernel are two encodings of the same LUT sum. ``"gather"`` runs
  the kernel's plain version (the JAX reference formulation). For
  ``top_k`` above the kernel's 256 every mode takes the plain version;
- k-means initial rows come from a ``torch.Generator`` seeded from
  ``seed``, so trained codebooks differ from the JAX package's bit for bit
  but not in quality. ``PQCodec.from_arrays`` adopts trained codebooks.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from vector_db_tpu_torch.device import require_f32_matmul, resolve_device
from vector_db_tpu_torch.ops.cuda.adc_scan import (
    adc_topk_long,
    adc_topk_plain,
)
from vector_db_tpu_torch.ops.kmeans import kmeans_multi, nearest

_LUT_ELEMS = 1 << 24  # bound on the LUT's [B, m, ksub, subdim] differences


def _split(rows: torch.Tensor, m: int) -> torch.Tensor:
    """f32[N, m * subdim] -> subspace-major f32[m, N, subdim]."""
    return rows.reshape(rows.shape[0], m, -1).transpose(0, 1)


def _encode(sub: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """sub: f32[m, N, subdim]; codebooks: f32[m, k, subdim] -> codes
    int32[N, m] (each subvector's nearest codeword)."""
    labels, _ = nearest(sub, codebooks)
    return labels.int().T


def _rotate(rows: torch.Tensor, rotation: Optional[torch.Tensor]):
    if rotation is None:
        return rows
    require_f32_matmul(rows)
    return rows @ rotation


def _encode_scan(
    emb: torch.Tensor,        # f32[N, dim], on any device
    codebooks: torch.Tensor,  # f32[m, k, subdim]
    chunk: int = 8192,
    rotation: Optional[torch.Tensor] = None,  # f32[dim, dim] (OPQ)
) -> torch.Tensor:
    """Large-corpus encoder: ``chunk`` rows at a time, each moved to the
    codebooks' device and rotated there (never a rotated copy of the
    table). Returns int32[N, m]."""
    m = codebooks.shape[0]
    out = [_encode(_split(_rotate(emb[r:r + chunk].to(codebooks.device),
                                  rotation), m), codebooks)
           for r in range(0, emb.shape[0], chunk)]
    return torch.cat(out) if out else torch.zeros(
        (0, m), dtype=torch.int32, device=codebooks.device)


def _encode_residual_scan(
    emb: torch.Tensor,        # f32[N, dim]
    cell_ids: torch.Tensor,   # int[N] coarse cell per row (>= 0)
    cent_rot: torch.Tensor,   # f32[k_cells, dim] rotated coarse centroids
    codebooks: torch.Tensor,  # f32[m, k, subdim]
    chunk: int = 8192,
    rotation: Optional[torch.Tensor] = None,  # f32[dim, dim] (OPQ)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual IVFADC encoder: codes the rotated residual ``x@R - c@R`` and
    returns, per row, the correction scalar ``s_x = 2 c_rot . recon_rot``
    (the FAISS precomputed-tables identity: query-time residual ADC is then
    ``sum_j lut[code_j] + s_x + (||q - c||^2 - ||q||^2)``).
    Returns (codes int32[N, m], s f32[N])."""
    m = codebooks.shape[0]
    sub_ids = torch.arange(m, device=codebooks.device)[None, :]
    codes, s = [], []
    for r in range(0, emb.shape[0], chunk):
        rows = _rotate(emb[r:r + chunk].to(codebooks.device), rotation)
        c_rows = cent_rot[cell_ids[r:r + chunk].to(codebooks.device).long()]
        code = _encode(_split(rows - c_rows, m), codebooks)   # [chunk, m]
        recon = codebooks[sub_ids, code.long()].reshape(rows.shape)
        codes.append(code)
        s.append(2.0 * (c_rows * recon).sum(-1))
    if not codes:
        return (torch.zeros((0, m), dtype=torch.int32, device=emb.device),
                torch.zeros((0,), dtype=torch.float32, device=emb.device))
    return torch.cat(codes), torch.cat(s)


def _decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """codes: int[N, m]; codebooks: f32[m, k, subdim] -> f32[N, m * subdim]."""
    m = codebooks.shape[0]
    sub_ids = torch.arange(m, device=codebooks.device)[None, :]
    return codebooks[sub_ids, codes.long()].reshape(codes.shape[0], -1)


def _adc_lut(queries: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """queries: f32[B, dim]; codebooks: f32[m, k, subdim] -> LUT
    f32[B, m, k] of per-subspace squared distances, from elementwise f32
    differences (no matmul, so TF32 cannot enter)."""
    b = queries.shape[0]
    m, k, subdim = codebooks.shape
    qsub = queries.reshape(b, m, 1, subdim)
    block = max(1, _LUT_ELEMS // (m * k * subdim))
    return torch.cat([((qsub[s:s + block] - codebooks[None]) ** 2).sum(-1)
                      for s in range(0, b, block)]) if b else \
        queries.new_zeros((0, m, k))


class PQCodec:
    """Train-once / encode-many product quantizer on a torch device."""

    def __init__(self, k: int, chunks: int, dim: int, device="cuda") -> None:
        if k <= 0:
            raise ValueError("k must be greater than 0")
        if chunks <= 0:
            raise ValueError("chunks must be greater than 0")
        if dim <= 0:
            raise ValueError("dim must be greater than 0")
        if dim % chunks != 0:
            raise ValueError("dim must be divisible by chunks")
        self.k = int(k)
        self.chunks = int(chunks)
        self.dim = int(dim)
        self.subdim = dim // chunks
        self.device = resolve_device(device)
        self.codebooks: Optional[torch.Tensor] = None  # f32[chunks, k, subdim]
        # OPQ rotation f32[dim, dim] (orthogonal) or None; L2 distances are
        # rotation-invariant, so ADC in the rotated space estimates the
        # original distances (Ge et al., OPQ)
        self.rotation: Optional[torch.Tensor] = None

    @classmethod
    def from_arrays(cls, codebooks: np.ndarray,
                    rotation: Optional[np.ndarray] = None,
                    device="cuda") -> "PQCodec":
        """A codec holding trained state: ``codebooks`` f32[chunks, k,
        subdim] and the optional OPQ ``rotation`` f32[dim, dim], e.g. a JAX
        ``PQCodec``'s ``np.asarray(codebooks)`` and ``np.asarray(rotation)``."""
        cb = np.asarray(codebooks, np.float32)
        if cb.ndim != 3:
            raise ValueError(f"codebooks must be [chunks, k, subdim], got "
                             f"shape {cb.shape}")
        codec = cls(k=cb.shape[1], chunks=cb.shape[0],
                    dim=cb.shape[0] * cb.shape[2], device=device)
        codec.codebooks = torch.tensor(cb, device=codec.device)
        if rotation is not None:
            r = np.asarray(rotation, np.float32)
            if r.shape != (codec.dim, codec.dim):
                raise ValueError(f"rotation must be [{codec.dim}, "
                                 f"{codec.dim}], got shape {r.shape}")
            codec.rotation = torch.tensor(r, device=codec.device)
        return codec

    def _validate(self, embeddings: np.ndarray) -> None:
        if not isinstance(embeddings, np.ndarray):
            raise TypeError("Embeddings must be a numpy array")
        if embeddings.ndim != 2:
            raise ValueError(
                f"Embeddings must be 2D array, got {embeddings.ndim}D"
            )
        if embeddings.shape[1] != self.dim:
            raise ValueError(
                f"Embedding dimension must be {self.dim}, "
                f"got {embeddings.shape[1]}"
            )

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            self.device)

    def _subspaces(self, embeddings: np.ndarray) -> torch.Tensor:
        return _split(_rotate(self._tensor(embeddings), self.rotation),
                      self.chunks)

    def train(self, embeddings: np.ndarray, seed: int = 0,
              iters: int = 100, restarts: int = 4,
              opq_iters: int = 0, opq_sample: int = 65536) -> None:
        """Train per-subspace codebooks, best inertia of ``restarts``
        k-means runs per subspace.

        ``opq_iters`` > 0 first learns an orthogonal rotation by the OPQ
        alternating procedure on up to ``opq_sample`` rows: rotate -> train
        light codebooks -> encode/decode -> Procrustes-update R from the
        SVD of X^T X_hat (on the host, in numpy, as the JAX package does).
        """
        self._validate(embeddings)
        if embeddings.shape[0] < self.k:
            raise ValueError(
                f"Need at least {self.k} vectors for {self.k} centroids"
            )
        x = embeddings.astype(np.float32)
        if opq_iters > 0:
            xs = x
            if xs.shape[0] > opq_sample:
                sel = np.random.default_rng(seed).choice(
                    xs.shape[0], opq_sample, replace=False
                )
                xs = xs[sel]
            xd = self._tensor(xs)
            require_f32_matmul(xd)
            r = torch.eye(self.dim, dtype=torch.float32, device=self.device)
            for t in range(opq_iters):
                sub = _split(xd @ r, self.chunks)
                cb, _ = kmeans_multi(
                    sub, self.k, torch.Generator().manual_seed(seed + 1 + t),
                    iters=12, restarts=1,
                )
                xhat = _decode(_encode(sub, cb), cb)  # rotated-space recon
                u, _, vt = np.linalg.svd((xd.T @ xhat).cpu().numpy())
                r = self._tensor(u @ vt)
            self.rotation = r
        self.codebooks, _ = kmeans_multi(
            self._subspaces(x), self.k, torch.Generator().manual_seed(seed),
            iters=iters, restarts=restarts,
        )

    def encode(self, embeddings: np.ndarray) -> np.ndarray:
        """int32[N, chunks] codes (streamed in row chunks)."""
        self._validate(embeddings)
        if self.codebooks is None:
            raise ValueError("Codec must be trained before encoding")
        x = torch.from_numpy(np.ascontiguousarray(embeddings, np.float32))
        return _encode_scan(x, self.codebooks,
                            rotation=self.rotation).cpu().numpy()

    def decode(self, codes: np.ndarray) -> np.ndarray:
        if self.codebooks is None:
            raise ValueError("Codec must be trained before decoding")
        c = torch.as_tensor(np.asarray(codes)).to(self.device)
        out = _decode(c, self.codebooks)
        if self.rotation is not None:  # back to the original space
            require_f32_matmul(out)
            out = out @ self.rotation.T
        return out.cpu().numpy()

    def rotate_queries(self, queries: np.ndarray) -> torch.Tensor:
        """Queries mapped into the (rotated) code space, on the device;
        identity when no OPQ rotation is trained."""
        return _rotate(self._tensor(queries), self.rotation)

    def adc_lut(self, queries: np.ndarray) -> torch.Tensor:
        if self.codebooks is None:
            raise ValueError("Codec must be trained before ADC")
        return _adc_lut(self.rotate_queries(queries), self.codebooks)

    def adc_search(
        self,
        queries: np.ndarray,
        codes,
        valid=None,
        top_k: int = 10,
        mode: str = "matmul",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Asymmetric-distance top-k over an encoded corpus (``codes``
        int[N, chunks] as numpy or a tensor; uint8 and int32 tensors are
        used as they are).

        ``"matmul"`` (default) and ``"pallas"`` run the ``adc_topk`` kernel
        on a CUDA device, ``"gather"`` its plain version; ``top_k`` past
        the kernel's lists (2048) takes passes of it. Returns (approx
        squared L2 f32[B, top_k], row indices int32[B, top_k]) ascending,
        (BIG, -1) padded past the valid rows."""
        if mode not in ("matmul", "pallas", "gather"):
            raise ValueError(f"Unknown ADC mode: {mode}")
        lut = self.adc_lut(queries)
        codes = torch.as_tensor(codes)
        if codes.dtype not in (torch.uint8, torch.int32):
            codes = codes.int()
        codes = codes.to(self.device).contiguous()
        if valid is None:
            valid = torch.ones((codes.shape[0],), dtype=torch.bool,
                               device=self.device)
        valid = torch.as_tensor(valid).to(self.device)
        top_k = int(top_k)
        if mode == "gather":
            d, i = adc_topk_plain(lut, codes, valid, top_k)
        else:
            d, i = adc_topk_long(lut, codes, valid, top_k)
        return d.cpu().numpy(), i.cpu().numpy()


class ProductQuantizationService:
    """Reference-shaped facade: ``compress`` trains and encodes in one call
    (reference pq.py:91-108)."""

    def __init__(self, k: int, chunks: int, dim: int, device="cuda") -> None:
        self._codec = PQCodec(k, chunks, dim, device=device)

    @property
    def k(self) -> int:
        return self._codec.k

    @property
    def chunks(self) -> int:
        return self._codec.chunks

    @property
    def dim(self) -> int:
        return self._codec.dim

    @property
    def subdim(self) -> int:
        return self._codec.subdim

    @property
    def centroids(self) -> Optional[List[np.ndarray]]:
        """A list of per-chunk centroid arrays, as the reference exposes."""
        if self._codec.codebooks is None:
            return None
        return list(self._codec.codebooks.cpu().numpy())

    def compress(self, embeddings: np.ndarray, seed: int = 0) -> np.ndarray:
        self._codec._validate(embeddings)
        self._codec.train(embeddings, seed=seed)
        return self._codec.encode(embeddings).astype(np.int64)
