"""The serving plane's open seams to the control plane.

The JAX package's serving code calls into its chaos plane (fault
injection) at five points and registers a fleet hook with its autopilot.
Neither plane is ported yet (ROADMAP queue 1 item 7), so each call site
in the port calls :func:`chaos_fire`, which never injects anything, and
names the JAX line it stands for:

* ``serving.kv`` — ``horovod_tpu/serving/generate/pages.py:138-146``;
* ``preemption`` — ``horovod_tpu/serving/replica.py:427`` (the replica's
  preemption watch);
* ``serving.request`` — ``replica.py:466`` (``/infer``) and ``:606``
  (``/generate``);
* ``chaos.install()`` in the replica process — ``replica.py:893``;
* the autopilot's ``scale_out`` hook — ``horovod_tpu/serving/fleet.py:443``.
"""

from __future__ import annotations

from typing import List, Tuple


def chaos_fire(seam: str) -> List[Tuple[str, str]]:
    """The faults armed at ``seam`` for this invocation, as the JAX
    ``chaos.fire(seam)`` returns them (``[(seam, kind), ...]``): always
    none until the port has a chaos plane."""
    return []
