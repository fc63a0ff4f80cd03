"""The cloud VM's metadata surface: maintenance notices and the VM probe.

The metadata half of ``horovod_tpu/runner/tpu_discovery.py``. A GPU VM on
GCE exposes the same instance metadata server as a TPU VM, and its
``instance/maintenance-event`` is the advance notice that the host is
about to be taken away, which the preemption watcher
(:mod:`horovod_tpu_torch.elastic.preemption`) turns into a planned drain.

Metadata facts (public GCE surface):
- server: ``http://metadata.google.internal/computeMetadata/v1/``,
  requests must carry ``Metadata-Flavor: Google``;
- ``instance/maintenance-event``: ``NONE`` when nothing is scheduled,
  ``TERMINATE_ON_HOST_MAINTENANCE`` (or ``MIGRATE_ON_HOST_MAINTENANCE``)
  when the host is doomed.

``HVD_TPU_METADATA_ENDPOINT`` overrides the server base URL (unit tests
point it at a local fake; nothing else should). Host enumeration (the JAX
module's ``tpu_pod_hosts`` and ``TpuPodDiscovery``) is not part of this
module.
"""

from __future__ import annotations

import os
import urllib.error
import urllib.request
from typing import Optional

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
