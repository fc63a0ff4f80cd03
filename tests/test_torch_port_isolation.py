"""The port stands alone: importing any module of horovod_tpu_torch loads
neither jax nor horovod_tpu, no source of the port (nor chip_smoke.py)
imports them, and no entry point drifts onto the CPU without being asked."""

import os
import re
import subprocess
import sys

import pytest
import torch

import horovod_tpu_torch
from horovod_tpu_torch.entry import _flagship_cfg, entry
from horovod_tpu_torch.models import Transformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "horovod_tpu_torch")
_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|optax|flax|horovod_tpu)(?:[.\s]|$)",
    re.M)


def _port_sources():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return [os.path.join(REPO, "chip_smoke.py")] + sorted(out)


def test_importing_every_module_loads_no_jax():
    code = (
        "import pkgutil, importlib, sys, horovod_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'flax', 'horovod_tpu'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 8 else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_import_nothing_of_jax():
    srcs = _port_sources()
    assert len(srcs) >= 9 and os.path.exists(srcs[0])
    for path in srcs:
        with open(path) as f:
            text = f.read()
        assert not _FORBIDDEN.search(text), path
        assert "horovod_tpu." not in text, path


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "from jax import numpy", "import jax.numpy",
                "  from horovod_tpu.ops import x", "import horovod_tpu"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import horovod_tpu_torch", "from horovod_tpu_torch import x",
               "# the jax package"):
        assert not _FORBIDDEN.search(ok), ok


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only case")


def test_entry_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(tiny=True)


def test_model_without_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError):
        Transformer(_flagship_cfg(tiny=True))


def test_device_helper_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError):
        horovod_tpu_torch.device()


def test_identity_from_env(monkeypatch):
    from horovod_tpu_torch.common import basics
    horovod_tpu_torch.shutdown()
    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", "3")
    monkeypatch.setenv("HVD_TPU_LOCAL_RANK", "2")   # HVD_TPU_* wins
    monkeypatch.setenv("HOROVOD_SIZE", "1")
    try:
        with pytest.raises(basics.NotInitializedError):
            horovod_tpu_torch.rank()
        horovod_tpu_torch.init()
        assert horovod_tpu_torch.is_initialized()
        assert (horovod_tpu_torch.rank(), horovod_tpu_torch.size()) == (0, 1)
        assert horovod_tpu_torch.local_rank() == 2
        assert horovod_tpu_torch.local_size() == 1
    finally:
        horovod_tpu_torch.shutdown()


def test_multi_process_world_raises(monkeypatch):
    horovod_tpu_torch.shutdown()
    monkeypatch.setenv("HVD_TPU_SIZE", "2")
    with pytest.raises(NotImplementedError, match="data-parallel"):
        horovod_tpu_torch.init()
    assert not horovod_tpu_torch.is_initialized()
