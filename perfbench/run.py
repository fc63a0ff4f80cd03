"""The benchmark of ``horovod_tpu_torch``, one cell a run:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

prints, as the last line of its standard output, one JSON object:
``correct``, ``attempted`` (steps in the window), ``failed`` (window
steps whose loss is not finite), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number the
comparison with the plain reference checked, beside its limit. The same
checks are the last lines of standard error.

It runs from the root of a checkout of the repository, on the cards of
the machine it is started on, and fails without printing a result when
they are missing. A cell of one rank runs in this process; a cell of
several is launched by the port's own launcher (``python -m
horovod_tpu_torch.runner.launch -np N``), each rank writing its record
into a temporary directory that this process reads and removes.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

CACHE = ROOT / "perfbench" / ".cache"
LAUNCH_TIMEOUT_S = 340


def _caches() -> None:
    """Build and kernel caches at fixed directories inside the checkout,
    CUDA's cache of the kernels it compiles from PTX among them (large
    enough to keep every one, so a later run finds them all)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["CUDA_CACHE_MAXSIZE"] = str(4 << 30)


def _refuse_banned() -> None:
    found = harness.banned_modules(sys.modules)
    if found:
        print(f"perfbench: the run loaded {found}: the benchmark and the "
              f"program under test must not load JAX or the JAX package",
              file=sys.stderr)
        sys.exit(3)


def _launch(args, cell) -> list:
    """Every rank's record, from the port's launcher."""
    out = Path(tempfile.mkdtemp(prefix="perfbench-"))
    try:
        cmd = [sys.executable, *cell.traffic["launcher"],
               "--output-filename", str(out / "logs"),
               sys.executable, str(Path(__file__).resolve()),
               "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace),
               "--worker", str(out)]
        proc = subprocess.Popen(cmd, cwd=ROOT, start_new_session=True)
        try:
            rc = proc.wait(timeout=LAUNCH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
        records = [json.loads(p.read_text())
                   for p in sorted(out.glob("rank*.json"))]
        if rc != 0 or len(records) != cell.ranks:
            for log in sorted((out / "logs").glob("rank.*/stderr")):
                sys.stderr.write(f"--- {log.parent.name} ---\n"
                                 + log.read_text()[-3000:])
            raise SystemExit(f"perfbench: the launched job ended with {rc} "
                             f"and {len(records)} of {cell.ranks} records")
        return records
    finally:
        shutil.rmtree(out, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    _caches()
    cell = harness.Cell(args.workload)

    if args.worker:
        rec = harness.run_rank(cell, args.seed, args.seconds,
                               bool(args.trace))
        rec["banned"] = harness.banned_modules(sys.modules)
        path = Path(args.worker) / f"rank{rec['rank']}.json"
        path.write_text(json.dumps(rec))
        return 0

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.ranks:
        print(f"perfbench: {cell.name} needs {cell.ranks} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell.ranks == 1:
        records = [harness.run_rank(cell, args.seed, args.seconds,
                                    bool(args.trace))]
    else:
        records = _launch(args, cell)
        for r in records:
            if r["banned"]:
                print(f"perfbench: rank {r['rank']} loaded {r['banned']}",
                      file=sys.stderr)
                return 3
    kind = records[0]["device_kind"]
    result = harness.summarize(cell, records, T_START, bool(args.trace),
                               kind)
    result["device"]["power_limit"] = harness.power_limit()
    _refuse_banned()
    marks = records[0]["setup_marks"]
    print("setup " + " ".join(f"{k} {v - T_START:.3f}"
                              for k, v in marks.items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
