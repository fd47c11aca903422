"""Hand-written CUDA kernels of the port, one wrapper module each.

Every wrapper takes its kernel's plain PyTorch version for a CPU tensor and
launches the kernel for a CUDA tensor, or raises; it never falls back. The
kernels build from ``vector_db_tpu_torch/csrc`` at first launch
(``vector_db_tpu_torch._build``).
"""

from __future__ import annotations

import torch


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


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
