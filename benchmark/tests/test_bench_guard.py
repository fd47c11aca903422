"""The import guard compares top-level module names whole."""

import sys
import types

from benchmark import guard
import vector_db_tpu_torch  # noqa: F401  (the program passes the guard)


def test_the_port_passes_and_the_jax_package_fails(monkeypatch):
    names = [n for n in sys.modules if n.split(".")[0] not in guard.FORBIDDEN]
    assert "vector_db_tpu_torch" in names
    assert guard.forbidden_modules(names) == []
    monkeypatch.setitem(sys.modules, "vector_db_tpu",
                        types.ModuleType("vector_db_tpu"))
    monkeypatch.setitem(sys.modules, "vector_db_tpu.index",
                        types.ModuleType("vector_db_tpu.index"))
    found = guard.forbidden_modules()
    assert "vector_db_tpu" in found and "vector_db_tpu.index" in found
    assert not any(n.startswith("vector_db_tpu_torch") for n in found)


def test_jax_names_fail_whole_names_only():
    assert guard.forbidden_modules(
        ["jax", "jaxlib.xla_client", "flax.linen", "jaxtyping", "flaxen",
         "numpy"]) == ["flax.linen", "jax", "jaxlib.xla_client"]
