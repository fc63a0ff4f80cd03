"""Build/packaging: compiles the native core (reference analog:
``setup.py`` CMake superbuild — plain make here) and installs the ``hvdrun``
console script (reference: ``setup.py:199``)."""

import os
import subprocess

from setuptools import setup, find_packages
from setuptools.command.build_ext import build_ext
from setuptools.command.build_py import build_py


def _make_core() -> None:
    cpp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp")
    if os.path.isdir(cpp):
        subprocess.run(["make", "-j4"], cwd=cpp, check=True)


class BuildWithCore(build_py):
    def run(self):
        _make_core()
        super().run()


class BuildCoreExt(build_ext):
    """`python setup.py build_ext` — the command the runtime's
    missing-library error advertises — must actually build the core."""

    def run(self):
        _make_core()
        super().run()


setup(
    name="horovod_tpu",
    version="0.1.0",
    description="TPU-native distributed training framework "
                "(Horovod-class capabilities on JAX/XLA)",
    packages=find_packages(include=["horovod_tpu*"]),
    # horovod_tpu_torch builds its CUDA kernels from these sources at first use
    package_data={"horovod_tpu.core": ["libhvdcore.so"],
                  "horovod_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    cmdclass={"build_py": BuildWithCore, "build_ext": BuildCoreExt},
    entry_points={
        "console_scripts": [
            "hvdrun = horovod_tpu.runner.launch:main",
            "horovodrun_tpu = horovod_tpu.runner.launch:main",
        ]
    },
    python_requires=">=3.10",
)
