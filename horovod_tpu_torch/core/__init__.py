"""The native coordination core (``libhvdcore``), built for the port.

The counterpart of ``horovod_tpu/core/__init__.py``: the same C++ core
(``cpp/*.cc``: the background loop that negotiates which named tensors
every rank has submitted, the response cache that skips that
negotiation in steady state, tensor fusion, and the TCP ring collectives),
compiled from the repository's sources into a library of the port's own.
The port never loads ``horovod_tpu/core/libhvdcore.so`` and never runs
``make`` in ``cpp/`` (which writes ``cpp/*.o`` and that library).
``collectives.cc`` and ``transport.cc`` are the port's copies beside this
module: in ``collectives.cc`` fp16 rounds to nearest with ties to even, as
numpy, torch and gloo do (``cpp/``'s rounds ties away from zero); in
``transport.cc`` a send to a peer whose frame failed its checksum fails with
the checksum message (``cpp/``'s names the broken socket). The other
sources are ``cpp/``'s.

:func:`library_path` builds at first use: one ``g++`` per source, all
started together, with ``cpp/Makefile``'s flags and the ``g++`` on
``PATH`` (see :func:`_cxx`), objects under
``build/horovod_tpu_torch/hvdcore-<hash>/`` and the library at
``build/horovod_tpu_torch/libhvdcore-<hash>.so``. The hash covers the
sources, the headers, the compiler and the flags, so an edited source is
rebuilt. A file
lock serializes processes that ask at once (the ranks of a world, test
workers), and the library is published by an atomic rename. A failed
build raises; nothing falls back to another engine.
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(_PKG)
CPP = os.path.join(REPO, "cpp")
BUILD_DIR = os.path.join(REPO, "build", "horovod_tpu_torch")
# cpp/Makefile's CXXFLAGS (warnings aside)
CXXFLAGS = ("-O2", "-g", "-std=c++17", "-fPIC", "-pthread")
SOURCES = ("transport.cc", "collectives.cc", "adasum.cc", "bayes_opt.cc",
           "core.cc", "timeline.cc", "capi.cc")
# the sources the port keeps a copy of, beside this module
PORT_SOURCES = ("transport.cc", "collectives.cc")


def _source(name: str) -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(here if name in PORT_SOURCES else CPP, name)

_lock = threading.Lock()


def _cxx() -> str:
    """The ``g++`` on ``PATH``. ``$CXX`` is not taken: a toolchain it names
    may bring a libstdc++ other than the one the process loads (on an
    H100 host whose ``CXX`` named a second GCC, that build segfaulted in
    its engine thread right after init; the system ``g++`` 13.3's ran)."""
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("no g++ on PATH to build the core")
    return cxx


def _digest() -> str:
    try:
        cxx = _cxx()
    except RuntimeError:
        cxx = ""
    h = hashlib.sha256(" ".join((cxx,) + CXXFLAGS).encode())
    paths = [_source(s) for s in SOURCES]
    paths += sorted(glob.glob(os.path.join(CPP, "*.h")))
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    """The port's ``libhvdcore``, built from ``cpp/`` if it is missing."""
    target = os.path.join(BUILD_DIR, f"libhvdcore-{_digest()}.so")
    if os.path.exists(target):
        return target
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        import fcntl
        with open(target + ".lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            if not os.path.exists(target):   # another process built it
                _build(target)
    return target


def _build(target: str) -> None:
    t0 = time.perf_counter()
    objdir = target[:-3].replace("libhvdcore-", "hvdcore-") + \
        f".{os.getpid()}"
    os.makedirs(objdir, exist_ok=True)
    cxx = _cxx()
    procs = []
    for src in SOURCES:
        obj = os.path.join(objdir, src[:-3] + ".o")
        procs.append((src, subprocess.Popen(
            [cxx, *CXXFLAGS, "-I", CPP, "-c", _source(src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{src}:\n{log}")
    if errors:
        shutil.rmtree(objdir, ignore_errors=True)
        raise RuntimeError("building the core failed:\n" + "\n".join(errors))
    tmp = f"{target}.{os.getpid()}.tmp"
    objs = [os.path.join(objdir, s[:-3] + ".o") for s in SOURCES]
    p = subprocess.run([cxx, "-shared", *CXXFLAGS, "-o", tmp, *objs],
                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if p.returncode != 0:
        shutil.rmtree(objdir, ignore_errors=True)
        raise RuntimeError(f"linking the core failed:\n{p.stdout}")
    os.replace(tmp, target)
    shutil.rmtree(objdir, ignore_errors=True)
    from horovod_tpu_torch.common.logging import get_logger
    get_logger().info("built %s in %.1f s", target, time.perf_counter() - t0)


def core_available() -> bool:
    """Whether the core can be built here (a C++ compiler and the
    sources), or is built already."""
    try:
        return os.path.exists(library_path())
    except RuntimeError:
        return False
