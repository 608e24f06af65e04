"""Nothing under perfbench/ imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "mvxnet_makise_tpu"}
PORT = "mvxnet_makise_tpu_torch"


def modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


def test_reference_and_accounting_import_nothing_of_the_program():
    for d in ("reference", "accounting"):
        for f in os.listdir(os.path.join(HERE, d)):
            if f.endswith(".py"):
                assert PORT not in set(imported(os.path.join(HERE, d, f)))


def test_run_loads_no_jax_module():
    import subprocess
    import sys

    code = ("import sys, perfbench.run, perfbench.readings;"
            "bad=[m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}];print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(HERE), check=True)
    assert out.stdout.strip() == "[]"
