"""Nothing under portbench/ imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the port; no
file reads the JAX package's benchmarks/."""
import ast
import pathlib

import pytest

from portbench.harness import result, spec

FILES = sorted(spec.HERE.rglob("*.py"))


def imported_tops(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and \
                node.args and isinstance(node.args[0], ast.Constant):
            tops.add(node.args[0].value.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(spec.HERE)) for p in FILES])
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & {*result.FORBIDDEN, "benchmarks"}
    if path.name == pathlib.Path(__file__).name:
        return      # this file names them to look for them
    consts = [n.value for n in ast.walk(ast.parse(path.read_text()))
              if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert not any(c.startswith("benchmarks") or "/benchmarks" in c
                   for c in consts)


def test_the_reference_imports_nothing_of_the_port():
    for path in (spec.HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in imported_tops(path), path


def test_forbidden_modules_compares_whole_top_level_names():
    assert result.forbidden_modules(
        {"repro_torch": 1, "repro_torch.models": 1, "numpy": 1}) == []
    assert result.forbidden_modules(
        {"repro.models": 1, "jaxlib": 1, "jax_like": 1}) == \
        ["jaxlib", "repro"]
