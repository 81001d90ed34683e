"""What the benchmark may not load: JAX, flax, the JAX package, and, in the
reference, anything of the system under test.

Names are compared by their top-level part (before the first dot) whole:
the system's package ``unmore_tpu_torch`` begins with the JAX package's
name ``unmore_tpu`` and is not it.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "unmore_tpu", "chip_smoke"})
SYSTEM = "unmore_tpu_torch"
REFERENCE = Path(__file__).resolve().parent / "reference"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """Names in ``sys.modules`` (or ``modules``) whose top level is forbidden."""
    return sorted(n for n in (sys.modules if modules is None else modules) if top(n) in FORBIDDEN)


def imports_of(path: Path) -> set[str]:
    """Top-level names that a Python source imports (absolute imports)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(top(node.module))
    return names


def source_problems(root: Path = Path(__file__).resolve().parent) -> list[str]:
    """Files of the benchmark that import something forbidden, and files of
    the reference that import the system."""
    problems = []
    for path in sorted(root.rglob("*.py")):
        bad = imports_of(path) & FORBIDDEN
        if REFERENCE in path.parents or path.parent == REFERENCE:
            bad |= imports_of(path) & {SYSTEM}
        if bad:
            problems.append(f"{path.relative_to(root)}: {sorted(bad)}")
    return problems
