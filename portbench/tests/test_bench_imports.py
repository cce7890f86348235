"""The import rule: nothing the benchmark runs imports JAX or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), and the reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from portbench.tests.helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "netobserv_tpu"}
SOURCES = sorted(p for p in (ROOT / "portbench").rglob("*.py")
                 if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if p.parent.name == "reference"],
    ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "netobserv_tpu_torch" not in set(_imports(path))


def test_top_level_names_are_compared_whole(monkeypatch):
    import types
    from portbench import run
    for name in ("netobserv_tpu_torch", "netobserv_tpu_torch.sketch",
                 "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert "netobserv_tpu" not in run.forbidden_modules()
    assert "jax" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "netobserv_tpu.sketch",
                        types.ModuleType("netobserv_tpu.sketch"))
    assert "netobserv_tpu" in run.forbidden_modules()


def test_a_run_loads_no_jax():
    """The harness, the program it drives and the reference, imported in
    a fresh process, leave no forbidden module loaded."""
    code = ("import portbench.harness, portbench.run, portbench.control, "
            "portbench.reference.control, netobserv_tpu_torch.exporter."
            "torch_sketch, netobserv_tpu_torch.datapath.fetcher; "
            "from portbench import run; print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.stdout.strip() == "[]"
