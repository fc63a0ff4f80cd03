"""Builds the port's CUDA C++ kernels and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes plain C entry points (``SIGNATURES``), so
``nvcc`` compiles it in seconds without PyTorch's headers. A build goes to
``build/horovod_tpu_torch/<name>-<hash>.so`` beside the package; the hash
covers the source, the headers under ``csrc/`` and the compiler flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.

Nothing is built when a module is imported: the first call on a CUDA
tensor builds, or :func:`build_all` builds every kernel at once (one
``nvcc`` per source, all started together). Every build is recorded as a
compile (:func:`horovod_tpu_torch.profiling.compile_watch.note_build`).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "horovod_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_I, _LL, _P, _F = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float
# each library (csrc/<name>.cu) and the argument types of its C entries;
# every entry returns cudaGetLastError() as an int, and every library
# exports ``<name>_error`` for the message
SIGNATURES = {
    "flash_attn_fwd": {
        "flash_attn_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                           _I, _F, _I, _P],
    },
    "xent_fwd": {
        "xent_fwd": [_P, _LL, _P, _P, _P, _LL, _I, _I, _I, _P],
    },
    "quantize": {
        "quantize": [_P, _P, _P, _LL, _I, _I, _I, _P],
        "quantize_ef": [_P, _P, _P, _P, _LL, _I, _I, _I, _P],
        "dequantize": [_P, _P, _P, _LL, _I, _I, _P],
        "fused_sgd0": [_P, _P, _P, _F, _LL, _I, _I, _P],
        "fused_sgd": [_P, _P, _P, _P, _P, _F, _F, _LL, _I, _I, _P],
        "fused_adam": [_P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _F, _F, _F,
                       _LL, _I, _I, _P],
    },
}
KERNELS = tuple(SIGNATURES)
ENTRIES = tuple(e for lib in SIGNATURES.values() for e in lib)

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
    with open(out + ".ptxas.txt", "w") as f:
        f.write(log)
    os.replace(f"{out}.{os.getpid()}.tmp", out)


def build_all(names: Iterable[str] = KERNELS) -> None:
    """Compile every kernel whose library is missing, in parallel."""
    with _lock:
        todo = [(n, _target(n)) for n in names]
        todo = [(n, t) for n, t in todo if not os.path.exists(t)]
        t0 = time.perf_counter()
        procs = [(_start(n, t), n, t) for n, t in todo]
        errors, seconds = [], {}
        for p, n, t in procs:
            try:
                _finish(p, n, t)
                seconds[n] = time.perf_counter() - t0
            except RuntimeError as e:
                errors.append(str(e))
        from horovod_tpu_torch.profiling import compile_watch
        compile_watch.note_build(seconds, time.perf_counter() - t0)
        if errors:
            raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``csrc/<name>.cu``, built at first use, with
    every entry of ``SIGNATURES[name]`` bound."""
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
            for entry, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, entry)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            err = getattr(lib, name + "_error")
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            lib.error_string = err
            _libs[name] = lib
        return _libs[name]


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of each kernel in ``csrc/<name>.cu``, from
    ptxas's ``-v`` report of its last build: ``{kernel: {"registers",
    "spill_stores", "spill_loads"}}``, keyed by the mangled name."""
    path = _target(name) + ".ptxas.txt"
    if not os.path.exists(path):
        return {}
    out: Dict[str, Dict[str, int]] = {}
    cur = None
    with open(path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = out.setdefault(m.group(1), {})
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                cur["spill_stores"] = int(m.group(1))
                cur["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def check(lib: ctypes.CDLL, entry: str, err: int) -> None:
    """Raise on the ``cudaGetLastError()`` value that ``entry`` of ``lib``
    returned."""
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}: "
                           f"{lib.error_string(err).decode(errors='replace')}")
