"""The port stands alone: no file of ``nemar_tpu_torch/``, and not
``chip_smoke.py``, imports the JAX package (``nemar_tpu`` or a submodule)
or JAX itself, neither at the top of a module nor inside a function. Nor
does any import Triton: every kernel of the port is CUDA C++ behind its
own PyTorch operator."""

import ast
import os
from pathlib import Path

import pytest

REPO = Path(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FILES = sorted((REPO / "nemar_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
BANNED = ("nemar_tpu", "jax", "flax", "optax", "orbax")


def _imports(path: Path) -> list:
    """(line, module) of every import statement in the file, and of every
    ``importlib.import_module`` / ``__import__`` call with a literal name."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.append((node.lineno, node.module))
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                arg = node.args[0]
                text = arg.value if isinstance(arg, ast.Constant) else "".join(
                    v.value for v in arg.values if isinstance(v, ast.Constant))
                found.append((node.lineno, str(text)))
    return found


def test_the_scan_sees_the_files():
    assert len(FILES) > 20
    assert any(p.name == "chip_smoke.py" for p in FILES)
    # the data-parallel layer is among them
    assert REPO / "nemar_tpu_torch" / "parallel" / "__init__.py" in FILES
    # the scan finds what it is looking for: the JAX package's own options
    # import nemar_tpu modules
    assert any(m.split(".")[0] == "nemar_tpu"
               for _, m in _imports(REPO / "nemar_tpu" / "options" / "base_options.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(REPO)) for p in FILES])
def test_port_file_imports_no_jax_package(path):
    bad = [(line, m) for line, m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_no_port_file_imports_triton():
    bad = [(str(p.relative_to(REPO)), line, m) for p in FILES for line, m in _imports(p)
           if m.split(".")[0] == "triton"]
    assert not bad, f"Triton imported by {bad}"
