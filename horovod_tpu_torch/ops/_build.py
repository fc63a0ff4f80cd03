"""Builds the port's CUDA C++ kernels and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C entry point, so ``nvcc`` compiles
it in seconds without PyTorch's headers. A build goes to
``build/horovod_tpu_torch/<name>-<hash>.so`` beside the package; the hash
covers the source, the headers under ``csrc/`` and the compiler flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.

Nothing is built when a module is imported: the first call on a CUDA
tensor builds, or :func:`build_all` builds every kernel at once (one
``nvcc`` per source, all started together).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "horovod_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# argument types of each library's C entry (csrc/<name>.cu); every entry
# returns cudaGetLastError() as an int
SIGNATURES = {
    "flash_attn_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                       _I, ctypes.c_float, _I, _P],
    "xent_fwd": [_P, _LL, _P, _P, _P, _LL, _I, _I, _I, _P],
}
KERNELS = tuple(SIGNATURES)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    paths = [os.path.join(CSRC, name + ".cu")]
    paths += sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc: subprocess.Popen, name: str, out: str) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(f"{out}.{os.getpid()}.tmp", out)


def build_all(names: Iterable[str] = KERNELS) -> None:
    """Compile every kernel whose library is missing, in parallel."""
    with _lock:
        todo = [(n, _target(n)) for n in names]
        todo = [(n, t) for n, t in todo if not os.path.exists(t)]
        procs = [(_start(n, t), n, t) for n, t in todo]
        errors = []
        for p, n, t in procs:
            try:
                _finish(p, n, t)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
    target = _target(name)
    if not os.path.exists(target):
        build_all([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(target)
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = SIGNATURES[name], ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise on the ``cudaGetLastError()`` value entry ``name`` returned;
    each library exports ``<name>_error`` for the message."""
    if err != 0:
        fn = getattr(lib, name + "_error")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(
            f"{name}: CUDA error {err}: {fn(err).decode(errors='replace')}")
