"""Build and load a kernel source of ``tecogan_tpu_torch/csrc``.

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use (never at import), into ``build/``
at the checkout's root (git-ignored).  The library's name carries the
source's hash, so an edited source is built anew and an unchanged one is
loaded as it is.  The kernel modules bind the C entry points with
``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def load(source: Path) -> Tuple[ctypes.CDLL, str]:
    """The loaded library of ``source``, compiled first unless
    ``build/`` already holds this source's library.  Returns it with the
    compiler's log ('' when nothing was compiled).  Raises on a failed
    build."""
    if source in _loaded:
        return _loaded[source], ""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    lib_path = BUILD_DIR / f"{source.stem}-{digest}.so"
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _loaded[source] = lib
    return lib, log
