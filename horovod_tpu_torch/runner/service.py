"""Driver/task bootstrap services with NIC probing.

A copy of ``horovod_tpu/runner/service.py`` (reference:
``horovod/runner/driver/driver_service.py:49-235`` +
``horovod/common/service/task_service.py:108``): before launching
workers, the launcher must learn which network interfaces are MUTUALLY
ROUTABLE across the hosts (a multi-NIC GPU VM has management, data and
GPUDirect NICs; the first address a hostname resolves to is often wrong).
The reference runs secret-authenticated socket RPC services on every host
and has each task probe the addresses of the next task; interfaces
reachable by the probing peer survive.

One small HMAC-authenticated JSON-over-HTTP service per task host (the
same transport family as the rendezvous KV store) with three verbs —
``addresses`` (list my NICs), ``probe`` (try a TCP connect from MY network
position), ``shutdown``. The driver collects registrations and runs the
probe. The wire is the JAX module's to the byte: ``POST /<verb>`` with a
JSON body and its HMAC-SHA256 in ``X-Hvd-Auth``, so a client of either
package talks to a service of the other.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import socket
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib import request as urlrequest


def get_local_addresses() -> Dict[str, str]:
    """Enumerate this host's (interface, IPv4) pairs — the reference walks
    psutil.net_if_addrs; here via SIOCGIFADDR so no extra dependency."""
    import fcntl
    out: Dict[str, str] = {}
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for _, name in socket.if_nameindex():
            try:
                packed = fcntl.ioctl(
                    s.fileno(), 0x8915,  # SIOCGIFADDR
                    struct.pack("256s", name.encode()[:15]))
                out[name] = socket.inet_ntoa(packed[20:24])
            except OSError:
                continue  # interface without an IPv4 address
    finally:
        s.close()
    return out


def _sign(secret: bytes, body: bytes) -> str:
    return hmac.new(secret, body, hashlib.sha256).hexdigest()


class _TaskHandler(BaseHTTPRequestHandler):
    service: "TaskService"

    def log_message(self, fmt, *args):  # silence
        pass

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(n)
        # secret-authenticated (reference: the launcher-generated secret
        # signs every service message)
        if not hmac.compare_digest(
                self.headers.get("X-Hvd-Auth", ""),
                _sign(self.service._secret, body)):
            self._reply(403, {"error": "bad signature"})
            return
        req = json.loads(body or b"{}")
        verb = self.path.strip("/")
        if verb == "addresses":
            self._reply(200, {"index": self.service.index,
                              "addresses": self.service.addresses()})
        elif verb == "probe":
            ok = self.service.probe(req["addr"], int(req["port"]),
                                    float(req.get("timeout", 2.0)))
            self._reply(200, {"ok": ok})
        elif verb == "shutdown":
            self._reply(200, {"ok": True})
            threading.Thread(target=self.service.stop, daemon=True).start()
        else:
            self._reply(404, {"error": f"unknown verb {verb}"})


class TaskService:
    """Per-host bootstrap service (reference: ``BasicTaskService``).

    ``addresses_override`` lets tests inject fake NIC tables.
    """

    def __init__(self, index: int, secret: bytes, port: int = 0,
                 addresses_override: Optional[Dict[str, str]] = None
                 ) -> None:
        self.index = index
        self._secret = secret
        self._addresses = addresses_override
        handler = type("Handler", (_TaskHandler,), {"service": self})
        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "TaskService":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()

    def addresses(self) -> Dict[str, str]:
        return self._addresses if self._addresses is not None \
            else get_local_addresses()

    def probe(self, addr: str, port: int, timeout: float = 2.0) -> bool:
        """Attempt a TCP connect FROM THIS HOST's network position."""
        try:
            with socket.create_connection((addr, port), timeout=timeout):
                return True
        except OSError:
            return False


def _call(addr: str, port: int, secret: bytes, verb: str,
          payload: dict, timeout: float = 10.0) -> dict:
    body = json.dumps(payload).encode()
    req = urlrequest.Request(
        f"http://{addr}:{port}/{verb}", data=body,
        headers={"X-Hvd-Auth": _sign(secret, body)})
    with urlrequest.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


class TaskClient:
    """Driver-side handle to one task service."""

    def __init__(self, addr: str, port: int, secret: bytes) -> None:
        self.addr = addr
        self.port = port
        self._secret = secret

    def addresses(self) -> Dict[str, str]:
        return _call(self.addr, self.port, self._secret, "addresses",
                     {})["addresses"]

    def probe(self, addr: str, port: int, timeout: float = 2.0) -> bool:
        return _call(self.addr, self.port, self._secret, "probe",
                     {"addr": addr, "port": port,
                      "timeout": timeout})["ok"]

    def shutdown(self) -> None:
        try:
            _call(self.addr, self.port, self._secret, "shutdown", {},
                  timeout=2.0)
        except OSError:
            pass


def find_routable_interfaces(
        tasks: List[TaskClient],
        restrict: Optional[List[str]] = None
) -> List[Tuple[int, Dict[str, str]]]:
    """All-peers probe (reference: ``_run_probe`` +
    ``get_common_interfaces``, ``driver/driver_service.py:49-235``): every
    OTHER task tries to reach each candidate address of task i; an
    interface survives only if every peer can connect. The full check
    (not just a ring) because the TCP core builds a FULL mesh — a NIC one
    peer can't reach would wedge rendezvous for exactly that peer.

    ``restrict``: user-provided interface allowlist (reference: --nics).
    """
    n = len(tasks)
    tables = [t.addresses() for t in tasks]
    if restrict:
        tables = [{k: v for k, v in tab.items() if k in restrict}
                  for tab in tables]
    # All (prober, candidate) pairs are independent — fan out in threads so
    # dead candidates cost one connect timeout total, not one per pair
    # (the reference driver probes concurrently too).
    jobs: List[Tuple[int, str, TaskClient, str, int]] = []
    for i, tab in enumerate(tables):
        for j, prober in enumerate(tasks):
            if j == i:
                continue
            for iface, ip in tab.items():
                jobs.append((i, iface, prober, ip, tasks[i].port))
    results: Dict[Tuple[int, str], bool] = {
        (i, iface): True for i, tab in enumerate(tables) for iface in tab}
    lock = threading.Lock()

    def run_job(job):
        i, iface, prober, ip, port = job
        ok = prober.probe(ip, port)
        if not ok:
            with lock:
                results[(i, iface)] = False

    threads = [threading.Thread(target=run_job, args=(j,), daemon=True)
               for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)

    out: List[Tuple[int, Dict[str, str]]] = []
    for i, tab in enumerate(tables):
        alive = {iface: ip for iface, ip in tab.items()
                 if results[(i, iface)]}
        if not alive:
            raise RuntimeError(
                f"no mutually-routable interface found for task {i} "
                f"(candidates: {tab}); pass an explicit interface list")
        out.append((i, alive))
    return out


def pick_rendezvous_address(routable: List[Tuple[int, Dict[str, str]]]
                            ) -> str:
    """Choose the coordinator address every worker can reach: task 0's
    first surviving interface (reference: the driver's common-interface
    pick feeding HOROVOD_GLOO_RENDEZVOUS_ADDR)."""
    idx, table = routable[0]
    # deterministic order: prefer non-loopback
    for iface in sorted(table):
        if not table[iface].startswith("127."):
            return table[iface]
    return next(iter(table.values()))
