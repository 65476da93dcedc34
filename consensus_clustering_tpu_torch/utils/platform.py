# Ported from consensus_clustering_tpu/utils/platform.py.
"""Entry-point set-up: the directory the CUDA kernels are built into.

The reference's module pins ``JAX_PLATFORMS`` against a plugin that
overrides it from a ``sitecustomize``, and points XLA's persistent
compilation cache at a durable directory.  Torch has no such plugin: the
port's entry points take an explicit device instead (``--device``,
``cuda`` unless the caller asks for ``cpu``).  Its one cache across
processes is the directory ``nvcc`` builds the kernels into
(:data:`..ops._build.BUILD_DIR`), which :func:`enable_compilation_cache`
chooses under the reference's knob.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

from consensus_clustering_tpu_torch.ops import _build


def enable_compilation_cache() -> str:
    """Choose the kernels' build directory from
    ``CCTPU_COMPILATION_CACHE`` and return it.

    - unset: the package's git-ignored ``_build/``
      (:data:`..ops._build.DEFAULT_BUILD_DIR`), shared by every process
      of the checkout, so a second process loads the libraries the first
      one built;
    - ``0``/``off``/``no``/``false``: a temporary directory of this
      process, removed at exit (every kernel is built anew);
    - any other value: that directory.

    Must run before the first kernel is built; later builds of the
    process land in the directory chosen last.
    """
    knob = os.environ.get("CCTPU_COMPILATION_CACHE", "")
    if knob.lower() in ("0", "off", "no", "false"):
        path = tempfile.mkdtemp(prefix="cctpu-kernels-")
        atexit.register(shutil.rmtree, path, True)
    else:
        path = knob or _build.DEFAULT_BUILD_DIR
    _build.BUILD_DIR = path
    return path
