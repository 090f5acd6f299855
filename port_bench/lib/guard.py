"""The import guard: no module of the JAX package, JAX or Flax may load in
a benchmark run, and the reference loads nothing of the port either.

Names are compared by their top-level part (before the first dot), whole:
``where2edit_tpu_torch`` begins with ``where2edit_tpu`` and is a different
package.
"""

from __future__ import annotations

import ast
import pathlib
import sys

JAX_NAMES = frozenset({"jax", "jaxlib", "flax", "where2edit_tpu"})
PORT_NAME = "where2edit_tpu_torch"


def loaded_forbidden(modules=None, forbidden=JAX_NAMES) -> list:
    """Sorted names in ``modules`` (default ``sys.modules``) whose
    top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in forbidden)


def check_loaded(where: str) -> None:
    """Exit with code 3, naming what was found on stderr, if a forbidden
    module is loaded."""
    bad = loaded_forbidden()
    if bad:
        print(f"port_bench: {where}: forbidden modules loaded: {bad[:20]}",
              file=sys.stderr)
        raise SystemExit(3)


def imported_names(path: pathlib.Path) -> set:
    """Top-level names of the modules a source file imports (absolute
    imports; relative ones stay inside their package)."""
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out
