"""What the benchmark may not load, compared by whole top-level names.

The port's package ``repro_torch`` begins with the JAX package's name
``repro``; only the part before the first dot, compared whole, tells
them apart.
"""
from __future__ import annotations

import ast
import pathlib
import sys

#: never loaded by a run, nor imported by any file of the benchmark
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})
#: further names the plain reference may not import: the program
PROGRAM = frozenset({"repro_torch"})


class Forbidden(RuntimeError):
    def __init__(self, found):
        super().__init__("loaded in this process: " + ", ".join(found))
        self.found = found


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({top(n) for n in names} & FORBIDDEN)


def imported(path: pathlib.Path) -> set:
    """Top-level names of every module a Python file imports, at any
    depth of its code (relative imports as ``portbench``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            out.add("portbench" if node.level else top(node.module))
    return out
