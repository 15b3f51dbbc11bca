"""What the benchmark may import, by whole top-level module names."""
import pathlib

import pytest

from portbench import imports

HERE = pathlib.Path(imports.__file__).resolve().parent
FILES = sorted(HERE.rglob("*.py"))
REFERENCE = sorted((HERE / "reference").rglob("*.py"))


def test_whole_names():
    assert imports.forbidden_loaded(["repro_torch", "repro_torch.models",
                                     "reprox", "jaxtyping"]) == []
    assert imports.forbidden_loaded(["repro.core", "jax.numpy", "flax",
                                     "jaxlib", "benchmarks.bench_x"]) == [
        "benchmarks", "flax", "jax", "jaxlib", "repro"]


def test_imported_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.models\nfrom repro import core\n"
                 "def g():\n    import jax.numpy as jnp\n"
                 "from . import weights\n")
    assert imports.imported(f) == {"repro_torch", "repro", "jax",
                                   "portbench"}


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imports.imported(path) & imports.FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_program(path):
    names = imports.imported(path)
    assert not names & (imports.FORBIDDEN | imports.PROGRAM)
    # what it takes from the benchmark is as plain: the weights' draws
    if "portbench" in names:
        assert not imports.imported(HERE / "weights.py") & (
            imports.FORBIDDEN | imports.PROGRAM | {"portbench"})


def test_a_run_loads_no_jax(tmp_path):
    import subprocess
    import sys
    code = ("import sys; sys.path[:0] = ['{root}', '{root}/src'];"
            "from portbench import harness, check, loop, profile;"
            "from portbench.reference import moe, budgets;"
            "from portbench.families import moe as fm;"
            "import repro_torch.serving.continuous;"
            "import repro_torch.core.allocator;"
            "from portbench import imports;"
            "print(imports.forbidden_loaded())").format(root=HERE.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
