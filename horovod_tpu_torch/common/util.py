"""Shared helpers (mirrors ``horovod_tpu/common/util.py``; reference:
``horovod/common/util.py``). The JAX module's ``is_traced`` asks whether a
leaf is a JAX tracer; eager PyTorch traces nothing, so it has no
counterpart here."""

from __future__ import annotations


def next_power_of_two(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()
