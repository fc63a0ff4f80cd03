"""The cloud VM's metadata surface: pod host enumeration, maintenance
notices and the VM probe.

A copy of ``horovod_tpu/runner/tpu_discovery.py``. A GPU VM on GCE exposes
the same instance metadata server as a TPU VM:

* ``instance/attributes/worker-network-endpoints`` lists the pod's worker
  VMs (``<uuid>:<worker-name>:<ip>`` entries, comma-separated). A TPU VM
  gets it from the platform; a GPU VM's instance template can set it as a
  custom attribute, with ``agent-worker-number`` and ``accelerator-type``
  beside it. :func:`pod_hosts` turns it into the launcher's hosts
  (``hvdrun --tpu``), and :class:`PodDiscovery` re-reads it for the
  elastic driver.
* ``instance/maintenance-event`` is the advance notice that the host is
  about to be taken away, which the preemption watcher
  (:mod:`horovod_tpu_torch.elastic.preemption`) turns into a planned drain.

One difference from the JAX module is the device model: a JAX process
drives all of a host's chips (one slot a host), a port process drives one
card. So a host's slots default to the launching host's
``torch.cuda.device_count()``; an explicit ``slots`` (or a process count
spread over the hosts) wins, and with neither a card nor explicit slots
the enumeration raises instead of taking one.

Metadata facts (public GCE surface):
- server: ``http://metadata.google.internal/computeMetadata/v1/``,
  requests must carry ``Metadata-Flavor: Google``;
- ``instance/maintenance-event``: ``NONE`` when nothing is scheduled,
  ``TERMINATE_ON_HOST_MAINTENANCE`` (or ``MIGRATE_ON_HOST_MAINTENANCE``)
  when the host is doomed.

``HVD_TPU_METADATA_ENDPOINT`` overrides the server base URL (unit tests
point it at a local fake; nothing else should). Off a metadata server,
every reader raises ``OSError``.
"""

from __future__ import annotations

import math
import os
import urllib.error
import urllib.request
from typing import Dict, List, Optional

from horovod_tpu_torch.runner.hosts import HostInfo

DEFAULT_ENDPOINT = "http://metadata.google.internal"
_ATTR_BASE = "/computeMetadata/v1/instance/attributes/"
_INSTANCE_BASE = "/computeMetadata/v1/instance/"

#: ``instance/maintenance-event`` value meaning "nothing scheduled";
#: anything else (``TERMINATE_ON_HOST_MAINTENANCE``, ``MIGRATE_ON_...``)
#: is an advance notice that this host is doomed.
MAINTENANCE_NONE = "NONE"


def _endpoint(endpoint: Optional[str]) -> str:
    return (endpoint or os.environ.get("HVD_TPU_METADATA_ENDPOINT")
            or DEFAULT_ENDPOINT).rstrip("/")


def metadata_get(attribute: str, endpoint: Optional[str] = None,
                 timeout: float = 5.0, attempts: int = 3,
                 base: str = _ATTR_BASE) -> str:
    """Fetch one instance attribute; raises ``OSError`` when not on a
    cloud VM (no metadata server) or the attribute is absent.

    Transient failures (connection resets from a briefly-restarting
    metadata server) are retried up to ``attempts`` times under a total
    deadline of ``attempts * timeout``
    (:mod:`horovod_tpu_torch.common.retry`); an HTTP error (absent
    attribute) or a non-HTTP answerer (captive portal) gives up
    immediately — patience will not change those."""
    import http.client

    from horovod_tpu_torch.common.retry import retry_call

    req = urllib.request.Request(
        _endpoint(endpoint) + base + attribute,
        headers={"Metadata-Flavor": "Google"})

    def do():
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read().decode().strip()

    try:
        # the same site name as the JAX module: one retry metric family
        # for both packages' metadata probes
        return retry_call(
            do, site="tpu_discovery",
            retry_on=(urllib.error.URLError, TimeoutError, OSError),
            give_up_on=(urllib.error.HTTPError,
                        http.client.HTTPException, UnicodeDecodeError),
            attempts=attempts, base_delay_s=0.1, max_delay_s=1.0,
            deadline_s=attempts * timeout)
    except (urllib.error.URLError, urllib.error.HTTPError,
            http.client.HTTPException, UnicodeDecodeError, OSError) as e:
        raise OSError(f"metadata attribute {attribute!r} unavailable: {e}") \
            from e


def _host_slots(slots: Optional[int], num_proc: Optional[int],
                n_hosts: int) -> int:
    """Processes a host: ``slots``, else ``num_proc`` spread over the
    hosts, else this host's card count; never a silent 1."""
    if slots is not None:
        return slots
    if num_proc:
        return math.ceil(num_proc / n_hosts)
    import torch
    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError(
            "pod host enumeration: this host has no CUDA device to count "
            "a host's slots by; pass the slots (--slots) or the process "
            "count (-np)")
    return n


def pod_hosts(slots: Optional[int] = None, endpoint: Optional[str] = None,
              num_proc: Optional[int] = None) -> List[HostInfo]:
    """All the pod's worker VMs, in worker order (the JAX
    ``tpu_pod_hosts``). ``slots`` is processes a host; by default
    ``num_proc`` spread over the hosts, else this host's card count (see
    the module docstring). Raises ``OSError`` off a metadata server."""
    raw = metadata_get("worker-network-endpoints", endpoint)
    # entry fields: <uuid>:<worker-name>:<ip>; be liberal and take the
    # last field so single-field test/bare-IP entries also work
    names = [e.strip().rsplit(":", 1)[-1] for e in raw.split(",")
             if e.strip()]
    if not names:
        raise OSError("worker-network-endpoints was empty")
    n = _host_slots(slots, num_proc, len(names))
    return [HostInfo(h, n) for h in names]


def worker_index(endpoint: Optional[str] = None) -> int:
    """This VM's worker number within the pod (the JAX
    ``tpu_worker_index``)."""
    return int(metadata_get("agent-worker-number", endpoint))


def accelerator_type(endpoint: Optional[str] = None) -> str:
    """The pod's accelerator type (the JAX ``tpu_accelerator_type``)."""
    return metadata_get("accelerator-type", endpoint)


class PodDiscovery:
    """Elastic host discovery backed by the metadata server (the JAX
    ``TpuPodDiscovery``; a drop-in for ``HostDiscoveryScript`` in
    ``runner/elastic/discovery.py``). Each refresh re-reads the pod's
    membership, so repaired or replaced worker VMs show up without a user
    discovery script; dead-but-listed workers are handled by the driver's
    blocklist like any other failed host."""

    def __init__(self, slots: Optional[int] = None,
                 endpoint: Optional[str] = None,
                 num_proc: Optional[int] = None):
        self._slots = slots
        self._endpoint = endpoint
        self._num_proc = num_proc

    def find_available_hosts_and_slots(self) -> Dict[str, int]:
        return {h.hostname: h.slots for h in
                pod_hosts(self._slots, self._endpoint, self._num_proc)}


def maintenance_event(endpoint: Optional[str] = None,
                      timeout: float = 2.0) -> str:
    """``instance/maintenance-event`` — the advance preemption /
    maintenance notice (``NONE`` when nothing is scheduled). The
    PreemptionWatcher polls this to drive a planned elastic drain instead
    of waiting for the host to die. Raises ``OSError`` off a cloud VM;
    the watcher latches metadata polling off after repeated failures."""
    return metadata_get("maintenance-event", endpoint, timeout=timeout,
                        attempts=1, base=_INSTANCE_BASE)


def running_on_cloud_vm(endpoint: Optional[str] = None,
                        timeout: float = 1.0) -> bool:
    """Cheap probe: is the instance metadata surface reachable from here?
    (The JAX ``running_on_tpu_vm`` reads ``worker-network-endpoints``, an
    attribute only a TPU VM has; a GPU VM answers ``instance/id``.)"""
    try:
        # attempts=1: the probe's point is to be cheap off a cloud VM,
        # where every attempt burns the full connect timeout
        metadata_get("id", endpoint, timeout=timeout, attempts=1,
                     base=_INSTANCE_BASE)
        return True
    except OSError:
        return False
