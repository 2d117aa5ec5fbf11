"""Nothing of the benchmark imports JAX or the JAX package, and its
reference imports nothing of the program: each import's top-level name,
the part before the first dot, compared whole (the port's name begins with
the JAX package's)."""

from __future__ import annotations

import ast
import os

from lspbench import manifest

JAX = {"jax", "jaxlib", "flax", "livespeechportraits_tpu"}


def _imports(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    tree = ast.parse(fh.read(), path)
                for node in ast.walk(tree):
                    if isinstance(node, ast.Import):
                        for a in node.names:
                            yield path, a.name.split(".")[0]
                    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                        yield path, node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    bad = [(p, m) for p, m in _imports(manifest.HERE) if m in JAX]
    assert bad == []


def test_the_reference_imports_nothing_of_the_program():
    names = {m for _, m in _imports(os.path.join(manifest.HERE, "reference"))}
    assert "livespeechportraits_torch" not in names and not names & JAX
    assert "livespeechportraits_torch" in {m for _, m in _imports(manifest.HERE)}  # the harness


def test_the_names_are_compared_whole():
    assert "livespeechportraits_torch".split(".")[0] not in JAX
