"""Device selection for the embedding model (the port of
vector_db_tpu/embedding/device.py): the reference's torch picker
(src/vector_db/inference/device.py:17-106), auto -> cuda -> mps -> cpu.

This picker places an embedding model only, and falls back to the CPU as
the reference's does. The index's device is the config's ``device`` through
``vector_db_tpu_torch.device.resolve_device``, which never falls back.
``"tpu"``, the JAX package's name for the accelerator, reads as ``"auto"``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


def _mps_available() -> bool:
    mps = getattr(torch.backends, "mps", None)
    return bool(mps is not None and mps.is_available())


def get_device(preference: str = "auto") -> str:
    """Resolve a device string. preference: 'auto' | 'cuda' | 'mps' | 'cpu'
    (case-insensitive, as the reference accepts 'CPU' in config.yaml:3)."""
    pref = (preference or "auto").lower()
    if pref == "cpu":
        return "cpu"
    if pref in ("auto", "tpu", "cuda") and torch.cuda.is_available():
        return "cuda"
    if pref in ("auto", "tpu", "mps") and _mps_available():
        return "mps"
    return "cpu"


def is_accelerator_available() -> bool:
    """True when torch sees a CUDA or MPS device (reference
    is_gpu_available, device.py:59-72)."""
    return torch.cuda.is_available() or _mps_available()


def get_device_info() -> Dict[str, Any]:
    """Summary of visible devices (reference get_device_info,
    device.py:75-106): the CUDA devices by name, else the CPU."""
    if torch.cuda.is_available():
        devices = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                   for i in range(torch.cuda.device_count())]
        platforms, backend = ["cuda"], "cuda"
    else:
        devices, platforms, backend = ["cpu"], ["cpu"], "cpu"
    return {
        "selected": get_device("auto"),
        "accelerator_available": is_accelerator_available(),
        "device_count": len(devices),
        "platforms": platforms,
        "devices": devices,
        "backend": backend,
    }
