"""``python -m horovod_tpu_torch.serving`` — run a local serving stack.

Mirrors ``horovod_tpu/serving/__main__.py``: spawns ``--replicas``
replica processes over ``--store-dir``, wires them behind an in-process
router, and serves the FRONT on ``--port``:

* ``POST /infer`` — ``{"id": ..., "x": [...]}`` through the router
  (admission control, hedging, retry); sheds answer 429 explicitly.
* ``POST /generate`` — ``{"id": ..., "prompt": [...], "max_new": n}``
  through the router's hedge-free generate path (replicas started with
  ``--mode generate``).
* ``GET /readyz`` — 200 once the fleet serves at least one READY
  replica; ``/healthz`` — process liveness + fleet view.
* ``GET /metrics`` — the front process's registry rendered as
  Prometheus text: the router-side ``hvd_serving_*`` counters and gauges
  (qps, p50/p99, shed/hedge/retry, fleet size).

Every replica runs on the card unless ``--device cpu``; without a card
and without ``--device cpu`` the replicas refuse to start and so does the
front. ``python -m horovod_tpu_torch.serving rollout status --store-dir D``
prints the rollout controller's persisted status.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler


class _FrontHandler(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):
        pass

    def _send(self, code: int, doc: dict) -> None:
        try:
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            pass

    def do_POST(self):
        from horovod_tpu_torch import tracing
        from horovod_tpu_torch.serving.batcher import SheddedError
        from horovod_tpu_torch.serving.router import (RequestFailed,
                                                      RequestRejected)
        path = self.path.split("?", 1)[0].rstrip("/")
        if path not in ("/infer", "/generate"):
            self._send(404, {"error": "not found"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(n))
        except (ValueError, OSError):
            self._send(400, {"error": "bad request body"})
            return
        router = self.server.router
        trace = tracing.decode(self.headers.get(tracing.TRACEPARENT))
        deadline_s = (float(doc["deadline_ms"]) / 1000.0
                      if "deadline_ms" in doc else None)
        try:
            if path == "/generate":
                resp = router.submit_generate(
                    doc.get("prompt") or [],
                    max_new=int(doc.get("max_new") or 16),
                    req_id=doc.get("id"), deadline_s=deadline_s,
                    trace=trace)
            else:
                resp = router.submit(doc.get("x"), req_id=doc.get("id"),
                                     deadline_s=deadline_s, trace=trace)
            self._send(200, resp)
        except SheddedError as e:
            self._send(429, {"error": str(e)})
        except RequestRejected as e:
            self._send(e.code, e.doc)  # the replica's own 4xx verdict
        except RequestFailed as e:
            self._send(503, {"error": str(e)})
        except Exception as e:  # the front must not die per request
            self._send(500, {"error": repr(e)})

    def do_GET(self):
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        fleet = self.server.fleet
        if path == "/metrics":
            from horovod_tpu_torch.metrics.registry import (
                default_registry, render_prometheus)
            body = render_prometheus(default_registry().snapshot())
            try:
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except OSError:
                pass
        elif path == "/readyz":
            live = fleet.live_count()
            self._send(200 if live > 0 else 503,
                       {"ready": live > 0, "replicas_live": live,
                        "replicas_target": fleet.target})
        elif path == "/healthz":
            self._send(200, {"status": "ok",
                             "replicas_live": fleet.live_count(),
                             "replicas_target": fleet.target})
        else:
            self._send(404, {"error": "not found"})


def _rollout_main(argv) -> int:
    """``python -m horovod_tpu_torch.serving rollout status --store-dir
    D``: print the rollout controller's persisted status doc (state,
    canary slots, split, transition history, trace id) from outside the
    controller's process. Exit 1 when no rollout ever ran there."""
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serving rollout")
    p.add_argument("command", choices=["status"])
    p.add_argument("--store-dir", required=True,
                   help="the store the rollout persists its status "
                        "next to")
    args = p.parse_args(argv)
    from horovod_tpu_torch.serving.rollout import read_status
    doc = read_status(args.store_dir)
    if doc is None:
        print(f"rollout: no status recorded under {args.store_dir!r} "
              "(no rollout ever ran against this store)")
        return 1
    print(json.dumps(doc, indent=1))
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "rollout":
        return _rollout_main(argv[1:])
    p = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.serving")
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--port", type=int, default=0,
                   help="front port for POST /infer, /generate and GET "
                        "/metrics (0 = ephemeral, printed at startup)")
    p.add_argument("--store-dir", default=None,
                   help="durable sharded store to serve (and hot-swap) "
                        "weights from")
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--mode", choices=("infer", "generate"),
                   default="infer")
    p.add_argument("--flagship", action="store_true",
                   help="generate replicas serve the flagship")
    p.add_argument("--device", default=None,
                   help="the replicas' device (default: the card)")
    p.add_argument("--ready-timeout", type=float, default=120.0)
    p.add_argument("--status-interval", type=float, default=5.0)
    p.add_argument("--duration", type=float, default=0.0,
                   help="exit after this many seconds (0 = forever)")
    args = p.parse_args(argv)

    from horovod_tpu_torch.common.config import env_int
    from horovod_tpu_torch.runner.http_kv import ThreadedHTTPServer
    from horovod_tpu_torch.serving import ReplicaFleet, Router
    if args.device is None:
        # fail here, not in every replica: the default is the card
        from horovod_tpu_torch.common.basics import device
        device()
    fleet = ReplicaFleet(size=args.replicas, store_dir=args.store_dir,
                         dim=args.dim, mode=args.mode, device=args.device,
                         extra_args=["--flagship"] if args.flagship else []
                         ).start(ready_timeout_s=args.ready_timeout)
    router = Router(fleet.endpoints)
    # handler pool sized from the ADMISSION budget (same rule the
    # replica applies to itself): the router's explicit 429 shed must
    # be reachable — a pool smaller than max_inflight would answer raw
    # 503 busy before admission control ever engaged.  An explicit
    # HVD_TPU_HTTP_MAX_HANDLERS wins verbatim (0 = unbounded).
    env_pool = env_int("HTTP_MAX_HANDLERS", -1)
    pool = env_pool if env_pool >= 0 else router.max_inflight + 16
    front = ThreadedHTTPServer(("0.0.0.0", args.port), _FrontHandler,
                               max_handlers=pool)
    front.router, front.fleet = router, fleet
    threading.Thread(target=front.serve_forever,
                     name="hvd-serving-front", daemon=True).start()
    print(f"serving: front on :{front.server_address[1]} "
          f"(/{args.mode}), {args.replicas} replicas {fleet.endpoints()}",
          flush=True)
    start = time.monotonic()
    try:
        while not args.duration \
                or time.monotonic() - start < args.duration:
            time.sleep(args.status_interval)
            acct = router.accounting()
            print(f"serving: live={fleet.live_count()}/{fleet.target} "
                  f"outcomes={acct['outcomes']}", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        front.shutdown()
        router.close()
        fleet.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
