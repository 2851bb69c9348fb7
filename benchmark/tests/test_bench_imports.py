"""Nothing of the benchmark imports JAX or the JAX package, and the
reference and its frozen copies import nothing of the program. Modules
are compared by their top-level names, whole: the port's name begins with
the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "vulkan_renderer_tpu"}
PORT = "vulkan_renderer_tpu_torch"


def sources(*dirs):
    for d in dirs:
        for base, _, files in os.walk(os.path.join(BENCH, d)):
            for name in files:
                if name.endswith(".py"):
                    yield os.path.join(base, name)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_top_level_names_are_compared_whole():
    import harness
    assert PORT.split(".")[0] not in harness.FORBIDDEN
    assert "vulkan_renderer_tpu" in harness.FORBIDDEN


def test_no_file_imports_jax_or_the_jax_package():
    for path in sources("."):
        found = set(top_level_imports(path)) & FORBIDDEN
        assert not found, (path, found)


@pytest.mark.parametrize("folder", ["reference", "frozen"])
def test_the_reference_imports_nothing_of_the_program(folder):
    for path in sources(folder):
        assert PORT not in set(top_level_imports(path)), path


def test_the_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.render, reference.scene, inputs; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (BENCH, FORBIDDEN | {PORT}))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    assert out.strip() == "[]"
