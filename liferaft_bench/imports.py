"""The import check: nothing the benchmark runs may load JAX or the JAX
package, and the reference may load nothing of the port.

Names are compared by their top-level part, whole: ``repro_torch`` (the
port) is not ``repro`` (the JAX package), though it begins with it.
``loaded`` reads ``sys.modules`` of the running process, so it catches
what the port pulls in as well as what the harness imports;
``reference_imports`` reads the reference's sources, which run in the same
process as the port and so cannot be told apart there.
"""
from __future__ import annotations

import ast
import sys

from . import PACKAGE

__all__ = ["FORBIDDEN", "FORBIDDEN_IN_REFERENCE", "top", "loaded",
           "reference_imports", "reference_violations"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
FORBIDDEN_IN_REFERENCE = FORBIDDEN | {"repro_torch"}


def top(module_name: str) -> str:
    return module_name.split(".", 1)[0]


def loaded(modules=None) -> list:
    """The modules of ``modules`` (``sys.modules``) whose top-level name
    is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if top(m) in FORBIDDEN)


def reference_imports() -> set:
    """Top-level names the reference's sources import; a relative import
    that leaves ``reference/`` counts as the harness (``liferaft_bench``)."""
    names = set()
    for path in sorted((PACKAGE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names.update(top(a.name) for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0:
                    names.add(top(node.module or ""))
                elif node.level > 1:
                    names.add("liferaft_bench")
    return names


def reference_violations() -> list:
    """What the reference imports that it must not: the JAX package, JAX,
    the port, or the harness beside it (which imports the port)."""
    return sorted(reference_imports()
                  & (FORBIDDEN_IN_REFERENCE | {"liferaft_bench"}))
