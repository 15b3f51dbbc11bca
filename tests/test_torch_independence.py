"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX, the JAX package or ``msgpack`` (the
checkpoint codec is the port's own), and the default device
refuses to fall back to the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.compat import cap_xdist_threads

cap_xdist_threads()   # one torch thread a worker under pytest-xdist

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_file_list_is_complete():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 20


def test_default_device_raises_without_a_card(monkeypatch):
    from repro_torch import compat
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compat.resolve_device()
    assert compat.resolve_device("cpu").type == "cpu"


DISTRIBUTION = ("repro_torch.sharding.context", "repro_torch.sharding.partition",
                "repro_torch.launch.mesh", "repro_torch.launch.shapes",
                "repro_torch.launch.steps", "repro_torch.launch.dryrun",
                "repro_torch.roofline.analysis")


def test_every_module_imports_without_jax_at_runtime():
    """Importing every module of the port (the distribution layer's
    among them) loads neither JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('NAMES', ','.join(names))\n"
        "print('BAD', ','.join(bad))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.startswith(("NAMES", "BAD")))
    names = lines["NAMES"].split(",")
    assert set(DISTRIBUTION) <= set(names)
    assert lines["BAD"].strip() == "", lines["BAD"]
