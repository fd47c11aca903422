"""Build the port's CUDA kernels with nvcc at first use; bind them with ctypes.

The sources are ``csrc/*.cu`` (plain C entry points, no PyTorch headers),
compiled in parallel, one nvcc each, in seconds. The shared library goes to
``build/kernels/`` at the repository root, named by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one is reused.
A missing ``nvcc`` or a failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from vector_db_tpu_torch.observability import count

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)
_LP = ctypes.POINTER(ctypes.c_longlong)
# entry point -> argtypes; every entry returns the launch's cudaError_t
_SIGNATURES = {
    # q (bf16, or f32 q_hi), q_lo, emb, qsq, xsq, valid, after_v, after_i,
    # B, N, d, k, nq, rows_per_split, splits, is_bf16, out_v, out_i, stream
    "vdb_l2_topk": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _L,
                    _I, _I, _P, _P, _P],
    # q, tab, xsq_eff, B, N, ds, m, is_bf16, vals, rows, stream
    "vdb_block_select": [_P, _P, _P, _I, _L, _I, _I, _I, _P, _P, _P],
    # lut, codes, corr, valid, B, P, m, ksub, out, stream
    "vdb_adc_probe": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # B, N, m, ksub, k, codes, is_u8, valid, *splits, *scratch
    "vdb_adc_topk_plan": [_I, _L, _I, _I, _I, _P, _I, _P, _IP, _LP],
    # lut, codes, is_u8, valid, row_bias, group_bias, group, after_v,
    # after_i, B, N, m, ksub, k, scratch, out_v, out_i, stream
    "vdb_adc_topk": [_P, _P, _I, _P, _P, _P, _L, _P, _P, _I, _L, _I, _I, _I,
                     _P, _P, _P, _P],
    # keys, is_bf16, vals, B, n, slice_w, topk, out_keys, out_vals, out_w,
    # stream
    "vdb_sorted_topk": [_P, _I, _P, _I, _L, _I, _I, _P, _P, _L, _P],
    # aug, n, dpa, idx, idx_stride, qa, B, K, out, stream
    "vdb_mirror_scores": [_P, _L, _I, _P, _L, _P, _I, _I, _P, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process ran, if any


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the port's CUDA "
            "kernels cannot be built")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libvdb_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise with the first failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}"
    if failed:
        raise RuntimeError(failed)


def build() -> Path:
    """Compile ``csrc/*.cu`` into the hashed library unless it exists: one
    nvcc per source, all started together, then one link."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cu, _ = _sources()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(cu, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            count("kernel.builds")
            so = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            so.vdb_error_string.argtypes = [ctypes.c_int]
            so.vdb_error_string.restype = ctypes.c_char_p
            _lib = so
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        name = _lib.vdb_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {name} ({err})")
