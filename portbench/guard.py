"""What the benchmark must not load: JAX and the JAX package, which the
program replaces, in the process that prints the result; and, in the
plain reference, anything of the program.  Modules are compared by their
top-level name (the part before the first dot), whole: the program's
name begins with the JAX package's.
"""

from __future__ import annotations

import ast
import os
import sys

JAX_PACKAGE = "particlesystemhybridcollisiondetection_tpu"
PROGRAM = "particlesystemhybridcollisiondetection_tpu_torch"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", JAX_PACKAGE})
REFERENCE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "reference")


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list:
    """Names in ``sys.modules`` whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top(n) in FORBIDDEN)


def imports_of(path: str) -> set:
    """Top-level names of the modules a Python file imports."""
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(top(node.module))
    return out


def reference_imports_bad(directory: str = REFERENCE_DIR) -> dict:
    """{file: forbidden names} over the reference's sources: the JAX side
    and the program."""
    bad = {}
    for f in sorted(os.listdir(directory)):
        if f.endswith(".py"):
            hit = imports_of(os.path.join(directory, f)) & (FORBIDDEN | {PROGRAM})
            if hit:
                bad[f] = sorted(hit)
    return bad
