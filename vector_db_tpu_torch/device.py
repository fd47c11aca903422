"""Devices are explicit in the port.

``resolve_device("cuda")`` on a machine without a GPU raises: the port never
carries on on the CPU when the card was asked for. The CPU is chosen only by
passing ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(spec="cuda") -> torch.device:
    dev = torch.device(spec)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch finds no CUDA "
            "device; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


# a config file's names for the card: the port's own, and the JAX package's
_ACCELERATOR = ("cuda", "auto", "tpu")


def config_device(spec="cuda") -> torch.device:
    """The index's device for a config file's ``device`` value
    (case-insensitive): the card for ``cuda``, ``auto`` and ``tpu`` (the JAX
    package's names for the accelerator), which raises without one; the
    CPU for ``cpu``."""
    name = str(spec or "cuda").lower()
    return resolve_device("cuda" if name in _ACCELERATOR else name)


def require_f32_matmul(t: torch.Tensor) -> None:
    """Raise if a float32 matrix product on ``t``'s device may run in TF32.

    Products under the exact contract must be true f32 (on the TPU the same
    trap was DEFAULT precision truncating to bf16)."""
    if t.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "exact f32 products would run in TF32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")
