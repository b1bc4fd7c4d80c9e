"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared library
with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

and loaded with ``ctypes``. The library name carries a hash of its source,
so an edited source is rebuilt. Outputs go to ``build/`` at the repository
root (git-ignored). ``build_all`` starts one ``nvcc`` per source, all at
once. A failed build raises; nothing falls back to the plain versions.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build, by source
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(DEFAULT_NVCC):
        return DEFAULT_NVCC
    raise RuntimeError(
        "nvcc not found on PATH or under /usr/local/cuda/bin: the CUDA "
        "kernels cannot be built"
    )


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1(
        (CSRC_DIR / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all(names: Optional[List[str]] = None) -> None:
    """Compile every named source (default: all of ``csrc/``) that has
    no up-to-date library, one ``nvcc`` process each, in parallel."""
    names = sources() if names is None else names
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append(
            (
                name,
                out,
                tmp,
                subprocess.Popen(
                    cmd,
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                ),
            )
        )
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: concurrent builders race safely
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
