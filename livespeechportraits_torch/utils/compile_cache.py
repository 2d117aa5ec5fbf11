"""Where the built kernels are kept between runs.

Counterpart of ``livespeechportraits_tpu/utils/compile_cache.py``, which
points JAX's persistent compilation cache at a directory.  The port
compiles no programs at run time; what it builds are the CUDA kernels of
``csrc/`` (``_build``: one library a hash of the sources and flags) and the
host codec (``native``), and the build directory is their cache: a second
boot on the same sources loads the library instead of running nvcc.  By
default both build into the repository's git-ignored ``build/``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

from livespeechportraits_torch import _build, native

ENV = "LSP_COMPILE_CACHE_DIR"


def enable(cache_dir: Optional[str] = None) -> str:
    """Build (and look for) the kernels and the host codec in ``cache_dir``,
    else in ``$LSP_COMPILE_CACHE_DIR`` when it is set and not empty, else in
    the default ``build/``; the directory is made if missing.  Takes effect
    for builds from this call on (a library already loaded stays).  Returns
    the directory in use."""
    if cache_dir is None:
        cache_dir = os.environ.get(ENV) or str(_build.DEFAULT_BUILD_DIR)
    path = Path(cache_dir).resolve()
    path.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = path
    native.BUILD_DIR = path
    return str(path)
