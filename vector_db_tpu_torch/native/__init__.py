"""Native (C++) host-runtime components, loaded via ctypes (the port's copy
of vector_db_tpu/native/__init__.py).

Build-on-first-use: the shared library compiles with g++ into
``build/native/`` at the repository root, named by a hash of the source,
through a temporary file and an atomic rename (a concurrent or interrupted
build never leaves a partial library). Callers fall back to pure-Python
implementations when no compiler is available (``metadata.MetadataIndex``
handles the fallback): this is a host index, and the fallback is the
reference's documented contract, not a device fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).parent / "metadata_index.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build(src: Path) -> Optional[Path]:
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"_metadata_index_{tag}.so"
    if out.exists():
        return out
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
             str(src), "-o", str(tmp)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
        return out
    except Exception:
        tmp.unlink(missing_ok=True)
        return None


def load_metadata_lib() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the native metadata index; None if no
    toolchain is available."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = _build(_SRC)
    if so is None:
        return None
    # A stale/foreign-platform .so must degrade to the Python fallback,
    # not crash StorageService init.
    try:
        lib = ctypes.CDLL(str(so))
        _bind_symbols(lib)
    except OSError:
        return None
    except AttributeError:
        return None
    _LIB = lib
    return _LIB


def _bind_symbols(lib: ctypes.CDLL) -> None:
    lib.mdx_new.restype = ctypes.c_void_p
    lib.mdx_free.argtypes = [ctypes.c_void_p]
    lib.mdx_set.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64,
    ]
    lib.mdx_remove.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.mdx_size.argtypes = [ctypes.c_void_p]
    lib.mdx_size.restype = ctypes.c_int64
    lib.mdx_query.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.mdx_query.restype = ctypes.c_int64
