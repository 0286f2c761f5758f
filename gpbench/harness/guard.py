"""The import guard: nothing the benchmark runs may load JAX or the JAX
package, and the plain reference may load nothing of the port.

Names compare by their top-level part (before the first dot), whole:
``xgpr_tpu_torch`` is not ``xgpr_tpu``.
"""
import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "xgpr_tpu"})
PORT = "xgpr_tpu_torch"


def top_level(name):
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None):
    """Sorted forbidden top-level names among loaded ``modules``
    (``sys.modules`` by default)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & FORBIDDEN)


def imported_names(path):
    """Top-level names of every module a Python file imports, by its
    syntax (absolute imports; relative ones stay in the package)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            names.add(top_level(node.module))
    return names
