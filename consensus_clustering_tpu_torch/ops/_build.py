"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled for ``sm_90a`` and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Libraries land in :data:`BUILD_DIR` (the package's
git-ignored ``_build/``, unless an entry point chose another directory with
:func:`..utils.platform.enable_compilation_cache`) under a name keyed by a
hash of the sources, so an edited source is rebuilt and a stale library is
never loaded.  A missing ``nvcc`` or a failed build raises; nothing falls
back.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, Iterator, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
DEFAULT_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
BUILD_DIR = DEFAULT_BUILD_DIR
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOADED: Dict[str, ctypes.CDLL] = {}
# Serialises builds and loads: two serve worker threads reaching a kernel
# first would otherwise both run nvcc for it.
_LOCK = threading.RLock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or a kernel source failed to compile."""


def find_nvcc() -> str:
    """The ``nvcc`` on PATH, else the one under ``$CUDA_HOME`` or
    ``/usr/local/cuda``; raises :class:`KernelBuildError` if none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(candidate) and os.access(candidate, os.X_OK):
        return candidate
    raise KernelBuildError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin or "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit"
    )


def _sources(name: str) -> List[str]:
    """The .cu file of ``name`` plus every shared header in csrc/."""
    main = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.isfile(main):
        raise KernelBuildError(f"no kernel source {main}")
    headers = sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith(".cuh")
    )
    return [main] + headers


def library_path(name: str) -> str:
    """Where the library of ``name`` lives for the current sources."""
    digest = hashlib.sha256()
    for path in _sources(name):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(ARCH_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def nvcc_command(nvcc: str, source: str, out: str) -> List[str]:
    """The command that compiles the .cu file ``source`` into the shared
    library ``out``."""
    return [
        nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out, source,
    ]


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the libraries of ``names`` that are not built yet, one
    ``nvcc`` per source, all started together.  Returns name -> the
    compiler's ``-Xptxas -v`` report (empty when already built)."""
    with _LOCK:
        names = list(names)
        pending = {n: library_path(n) for n in names}
        pending = {n: p for n, p in pending.items() if not os.path.isfile(p)}
        reports = {n: "" for n in names}
        if not pending:
            return reports
        nvcc = find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name, path in pending.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[name] = (tmp, path, subprocess.Popen(
                nvcc_command(nvcc, os.path.join(CSRC_DIR, f"{name}.cu"), tmp),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        failures = []
        for name, (tmp, path, proc) in procs.items():
            output, _ = proc.communicate()
            reports[name] = output
            if proc.returncode != 0:
                os.unlink(tmp)
                failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{output}")
            else:
                os.replace(tmp, path)
        if failures:
            raise KernelBuildError("kernel build failed: " + "\n".join(failures))
        return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _LOADED[name] = lib
        return lib


@contextlib.contextmanager
def library_override(name: str, path: str) -> Iterator[ctypes.CDLL]:
    """Within the context, :func:`load` of ``name`` returns the library
    at ``path`` (a variant build of ``csrc/<name>.cu``) instead of the
    checkout's own."""
    saved = _LOADED.get(name)
    _LOADED[name] = lib = ctypes.CDLL(path)
    try:
        yield lib
    finally:
        if saved is None:
            _LOADED.pop(name, None)
        else:
            _LOADED[name] = saved
