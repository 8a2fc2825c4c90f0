"""No module of the benchmark imports JAX, jaxlib, flax or the JAX package
(``tecogan_tpu``), comparing each imported module's top-level name whole:
``tecogan_tpu_torch`` begins with ``tecogan_tpu`` and is allowed.  The
port is imported only by each architecture's ``program.py`` and by the
faults; an architecture's reference imports nothing of the program at
all: only ``torch``, the standard library, the shared frame helpers
(``benchmark/reference/``) and its own modules."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark import run

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "tecogan_tpu"}


def _imports(path: Path):
    """(module name, level) of every import in ``path``."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name, 0) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append((node.module or "", node.level))
    return out


SOURCES = sorted(HERE.rglob("*.py"))
REFERENCES = sorted(HERE.glob("reference/*.py")) + sorted(
    HERE.glob("architectures/*/reference/*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    bad = [n for n, level in _imports(path) if level == 0 and n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", REFERENCES, ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    for name, level in _imports(path):
        assert level <= 1, f"{path.name} reaches outside its own reference package"
        top = name.split(".")[0]
        assert level == 1 or top in ("torch", "__future__") or top in sys.stdlib_module_names \
            or name.startswith("benchmark.reference"), f"{path} imports {name}"


def test_only_the_system_under_test_and_its_faults_import_the_port():
    users = [p.relative_to(HERE) for p in SOURCES if "tests" not in p.parts
             and any(n.split(".")[0] == "tecogan_tpu_torch" for n, level in _imports(p)
                     if level == 0)]
    programs = [f"architectures/{d.name}/program.py"
                for d in sorted(HERE.glob("architectures/*/")) if (d / "program.py").is_file()]
    assert programs and sorted(str(p) for p in users) == sorted(["faults.py"] + programs)


def test_the_run_names_loaded_jax_modules_by_whole_name(monkeypatch):
    for name in ("tecogan_tpu_torch", "tecogan_tpu_torch.engine", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == [] or all(
        m.split(".")[0] in FORBIDDEN for m in run.forbidden_modules())
    before = set(run.forbidden_modules())
    for name in ("jax", "tecogan_tpu.ops", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(run.forbidden_modules()) - before == {"jax", "tecogan_tpu.ops", "flax.linen"}
