"""Build and load the port's CUDA kernels and its host library.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared library
with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

and loaded with ``ctypes``. The library name carries a hash of its source,
so an edited source is rebuilt. Outputs go to ``build/`` at the repository
root (git-ignored). ``build_all`` starts one ``nvcc`` per source, all at
once. A failed build raises; nothing falls back to the plain versions.
Nothing here runs at import time.

The host library is the other kind: each ``csrc/<name>.cpp`` (C++ for the
card's host CPU, no GPU code) is compiled on first use by

    g++ -O3 -std=c++17 -fPIC -pthread -shared -o build/<lib> csrc/<name>.cpp

``shardio.cpp`` into ``libshardio-<hash>.so``, a plain-C library for
``ctypes``; ``seqencode.cpp``, with ``-I`` of Python's headers, into the
CPython extension ``_seqencode-<hash><EXT_SUFFIX>``. ``sources`` and
``build_all`` mean the ``.cu`` files only, ``host_sources`` and
``build_host`` the ``.cpp`` files. A missing ``g++`` or a failed build
raises ``RuntimeError`` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Union

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

GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]
# host sources built as CPython extensions (module name _<name>), with the
# flags they add to GXX_FLAGS
HOST_EXTENSIONS = {"seqencode": ["-I" + sysconfig.get_paths()["include"]]}

_lock = threading.Lock()
_libs: Dict[str, Union[ctypes.CDLL, ModuleType]] = {}
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


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "g++ not found on PATH: the host library cannot be built"
        )
    return found


def _host_flags(name: str) -> List[str]:
    return GXX_FLAGS + HOST_EXTENSIONS.get(name, [])


def host_lib_path(name: str) -> Path:
    """Where ``csrc/<name>.cpp`` is built: a name carrying a hash of the
    source and the flags (and, for an extension, Python's EXT_SUFFIX)."""
    flags = _host_flags(name)
    digest = hashlib.sha1(
        (CSRC_DIR / f"{name}.cpp").read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:12]
    if name in HOST_EXTENSIONS:
        suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
        return BUILD_DIR / f"_{name}-{digest}{suffix}"
    return BUILD_DIR / f"lib{name}-{digest}.so"


def host_sources() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cpp"))


def build_host(names: Optional[List[str]] = None) -> None:
    """Compile every named host source (default: every ``csrc/*.cpp``) that
    has no up-to-date library, one ``g++`` process each, in parallel; each
    output is published with ``os.replace``, so concurrent builds (test
    workers, the ranks of a group) race safely."""
    names = host_sources() if names is None else names
    todo = [n for n in names if not host_lib_path(n).exists()]
    if not todo:
        return
    gxx = _gxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = host_lib_path(name)
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [gxx, *_host_flags(name), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cpp")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_logs[f"{name}.cpp"] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cpp (g++ exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("host library build failed:\n" + "\n".join(failed))


def load_host(name: str) -> Union[ctypes.CDLL, ModuleType]:
    """The loaded library of ``csrc/<name>.cpp``, built if needed: a
    ``ctypes.CDLL``, or the module of a source in ``HOST_EXTENSIONS``."""
    key = f"{name}.cpp"
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build_host([name])
            path = host_lib_path(name)
            if name in HOST_EXTENSIONS:
                import importlib.machinery
                import importlib.util

                loader = importlib.machinery.ExtensionFileLoader(
                    f"_{name}", str(path))
                spec = importlib.util.spec_from_file_location(
                    f"_{name}", str(path), loader=loader)
                lib = importlib.util.module_from_spec(spec)
                loader.exec_module(lib)
            else:
                lib = ctypes.CDLL(str(path))
            _libs[key] = lib
        return lib
