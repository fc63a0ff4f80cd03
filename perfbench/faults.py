"""Faults planted underneath the timed path, to show that the comparison
catches them. The benchmark's own runs plant none; ``calibrate.py`` reads
them on the chip and ``tests/test_perfbench_faults.py`` on the CPU.

* ``unchanged``: the step returns its state unchanged (parameters,
  running statistics and optimizer state as they were before it).
* ``half_batch``: half of this rank's rows are left out; the loss is the
  mean over the rest.
* ``no_exchange``: the gradient exchange between ranks is left out (each
  rank steps on its own share); it changes nothing in a world of one.
* ``stats_frozen``: the step leaves the running statistics (a batch
  norm's running means and variances) as they were before it; a model
  without them has nothing to freeze.
* ``leaf_doubled``: the gradient of the largest leaf reaches the optimizer
  doubled, as a bucket unpacked twice would leave it.
"""

from __future__ import annotations

from contextlib import ExitStack
from unittest import mock

import torch

NAMES = ("unchanged", "half_batch", "no_exchange", "stats_frozen",
         "leaf_doubled")


def _half(x):
    if isinstance(x, dict):
        return {k: _half(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_half(v) for v in x)
    return x[: x.shape[0] // 2]


def plant(name, stack: ExitStack, prog: dict) -> None:
    """Break ``prog`` (the harness's ``model``/``call``/``local`` record)
    with fault ``name`` for as long as ``stack`` is open."""
    if name is None:
        return
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}; expected one of {NAMES}")
    call, local, model = prog["call"], prog["local"], prog["model"]
    if name == "unchanged":
        def frozen(model, optimizer, feed):
            before = {k: v.clone() for k, v in model.state_dict().items()}
            state = {p: {k: v.clone() if hasattr(v, "clone") else v
                         for k, v in s.items()}
                     for p, s in optimizer.state.items()}
            loss = call(model, optimizer, feed)
            model.load_state_dict(before)
            optimizer.state.clear()
            optimizer.state.update(state)
            return loss
        prog["call"] = frozen
    elif name == "stats_frozen":
        def stale(model, optimizer, feed):
            before = [(b, b.clone()) for b in model.buffers()]
            loss = call(model, optimizer, feed)
            with torch.no_grad():
                for b, old in before:
                    b.copy_(old)
            return loss
        prog["call"] = stale
    elif name == "half_batch":
        prog["local"] = lambda batch: _half(local(batch))
    elif name == "no_exchange":
        from horovod_tpu_torch.models import _flax, bert
        for mod in (_flax, bert):
            stack.enter_context(mock.patch.object(
                mod, "sync_grads", lambda model, axes: None))
    elif name == "leaf_doubled":
        big = max(model.parameters(), key=lambda p: p.numel())

        def double(optimizer, args, kwargs):
            if big.grad is not None:
                big.grad.mul_(2.0)
        handle = prog["optimizer"].register_step_pre_hook(double)
        stack.callback(handle.remove)
