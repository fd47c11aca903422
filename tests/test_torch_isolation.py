"""vector_db_tpu_torch runs without jax, and never falls back to the CPU
when a GPU was asked for."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from vector_db_tpu_torch.index.flat import FlatIndex

ROOT = Path(__file__).resolve().parent.parent


def test_port_never_imports_jax():
    script = textwrap.dedent("""
        import sys

        import numpy as np
        import torch

        import vector_db_tpu_torch as vt

        rng = np.random.default_rng(0)
        x = rng.standard_normal((300, 16)).astype(np.float32)
        for precision in ("f32", "bf16", "blocksel", "blocksel2p"):
            idx = vt.FlatIndex(device="cpu", precision=precision,
                               bf16_guard="off")
            idx.insert_nodes([vt.Node(id=i, embedding=x[i])
                              for i in range(300)])
            _, ids = idx.search_batch(x[:3], 4)
            assert (ids[:, 0] == [0, 1, 2]).all(), (precision, ids)
        assert "jax" not in sys.modules, sorted(
            m for m in sys.modules if m.startswith("jax"))
        if not torch.cuda.is_available():
            try:
                vt.FlatIndex(device="cuda")
            except RuntimeError as e:
                assert "CUDA" in str(e)
            else:
                raise AssertionError("FlatIndex(device='cuda') ran without a GPU")
        print("isolated")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"


def test_default_device_is_cuda_and_raises_without_one():
    if torch.cuda.is_available():
        assert FlatIndex().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FlatIndex()
