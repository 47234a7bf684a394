"""No module of the benchmark imports JAX or the JAX package, and the
references import nothing of the port (top-level names compared whole)."""
import ast
import os

from benchlib import common


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _files(top):
    for d, _, fs in os.walk(top):
        if ".cache" in d:
            continue
        yield from (os.path.join(d, f) for f in fs if f.endswith(".py"))


def test_no_jax_anywhere_and_no_port_in_the_references():
    bad = [(f, m) for f in _files(common.BENCH_DIR) for m in _imports(f)
           if m in ("jax", "jaxlib", "flax", "adfmsl")]
    assert not bad
    ref = os.path.join(common.BENCH_DIR, "reference")
    assert not [(f, m) for f in _files(ref) for m in _imports(f)
                if m in ("adfmsl_torch", "benchlib")]


def test_the_guard_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "adfmsl_torch_like", types.ModuleType("adfmsl_torch_like"))
    assert "adfmsl_torch_like" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "adfmsl.models", types.ModuleType("adfmsl.models"))
    assert common.forbidden_modules() == ["adfmsl.models"]
