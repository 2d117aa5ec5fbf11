"""Nothing of the benchmark imports JAX or the JAX package, and its
reference imports nothing of the program: each import's top-level name,
the part before the first dot, compared whole (the port's name begins with
the JAX package's)."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

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


# each module of lspbench/reference/ in turn, in one fresh process: the
# top-level names of what sys.modules gained with it, its imports' imports too
_LOADS = """
import importlib, json, os, sys
here = os.path.join("lspbench", "reference")
names = lambda: {m.split(".")[0] for m in sys.modules}
out = {}
for f in sorted(os.listdir(here)):
    if f.endswith(".py"):
        before = names()
        importlib.import_module("lspbench.reference." + f[:-3])
        out[f] = sorted(names() - before)
print(json.dumps(out))
"""


def test_no_reference_module_loads_the_program_even_through_another():
    env = {**os.environ, "USE_FLAX": "0", "USE_JAX": "0"}
    done = subprocess.run([sys.executable, "-c", _LOADS], cwd=manifest.ROOT, env=env,
                          capture_output=True, text=True, timeout=300, check=True)
    loads = json.loads(done.stdout.strip().splitlines()[-1])
    assert "subject.py" in loads and "transfer.py" in loads
    bad = {f: sorted(set(m) & (JAX | {"livespeechportraits_torch"})) for f, m in loads.items()}
    assert {f: m for f, m in bad.items() if m} == {}
