"""Nothing of JAX or of the JAX package may run in the benchmark.

Names are compared by their top-level part, the text before the first
dot, as a whole word: `trino_tpu_torch` (the port) begins with
`trino_tpu` (the JAX package) and is neither of them."""
from __future__ import annotations

import ast
import sys
from typing import Iterable, Set

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "trino_tpu"})
PORT = "trino_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded(forbidden: Iterable[str] = FORBIDDEN) -> Set[str]:
    """Top-level names of forbidden modules this process has loaded."""
    bad = set(forbidden)
    return {top(m) for m in list(sys.modules) if top(m) in bad}


def imports_of(path: str) -> Set[str]:
    """Top-level names a source file imports (absolute imports only;
    a relative import stays inside its own package)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(top(node.module))
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(top(str(node.args[0].value)))
    return names
