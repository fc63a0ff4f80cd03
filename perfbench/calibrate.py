"""The readings the limits of ``limits/<cell>.json`` are set from, many
runs of one cell in one process (the world and the kernels built once):

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control] [--faults half_batch,stats_frozen,...] \\
        [--fault-seeds N] [--seconds S] [--out FILE]

Each reading is a run of the cell as ``run.py`` makes it
(``harness.run_rank``, then ``harness.summarize`` at the cell's limits),
with a window of ``--seconds``: the sound program on every seed, and on
the first ``--fault-seeds`` seeds each fault of ``faults.py`` planted
underneath the timed path. With ``--control`` the control on those
seeds: the reference put in the program's place in the precision below
the configuration's (``reference/common.py``'s ``fp8``), compared with
the fp32 reference and judged at the same limits. A cell of several
ranks runs under the port's launcher, each rank running this script;
rank 0 reports. One JSON line a reading on standard output (and in
``--out``): the numbers compared and ``correct``; then, of each number,
the largest sound reading and the smallest reading of the control and of
each fault.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench import harness, judge  # noqa: E402


def control(cell, seed: int, device) -> dict:
    """The control's numbers for ``seed`` and its verdict at the cell's
    limits: rank 0 alone, as the reference runs."""
    ref = harness.reference_steps(cell, seed, device, "fp32", keep=True)
    low = harness.reference_steps(cell, seed, device, "fp8", keep=True)
    low["diff"] = harness.vector_diffs(low.pop("vectors"),
                                       ref.pop("vectors"), device)
    numbers = {**judge.compare(low, ref), "window_nonfinite": 0.0}
    if cell.ranks > 1:
        numbers["replicas_differ"] = 0.0
    correct, checks = judge.verdict(numbers, cell.limits)
    return {"correct": correct, "checks": checks, "numbers": numbers}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3,
                    help="plant the faults and run the control on the "
                         "first N seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    cell = harness.Cell(args.workload)
    hvd.init()
    ctl = harness._Control(hvd.size())
    dev = hvd.device()
    planted = [f for f in args.faults.split(",") if f]
    lines = []

    def emit(line: dict) -> None:
        line = {"cell": cell.name, **line}
        lines.append(line)
        print(json.dumps(line), flush=True)

    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        for fault in [None] + (planted if n < args.fault_seeds else []):
            rec = harness.run_rank(cell, seed, args.seconds, False,
                                   fault=fault, shutdown=False)
            records = [rec]
            if ctl.group is not None:
                records = [None] * hvd.size()
                dist.all_gather_object(records, rec, group=ctl.group)
            if hvd.rank() == 0:
                out = harness.summarize(cell, records, 0.0, False,
                                        rec["device_kind"])
                emit({"seed": seed, "what": fault or "program",
                      "correct": out["correct"], "checks": out["checks"],
                      "numbers": judge.compare(rec["program"],
                                               rec["reference"])})
        if hvd.rank() == 0 and args.control and n < args.fault_seeds:
            emit({"seed": seed, "what": "control",
                  **control(cell, seed, dev)})
    if hvd.rank() == 0:
        summary = {}
        for line in lines:
            s = summary.setdefault(line["what"], {"correct": []})
            pick = max if line["what"] == "program" else min
            for k, c in line["checks"].items():
                v = c["value"]
                if v is not None:
                    s[k] = v if k not in s else pick(s[k], v)
            s["correct"].append(line["correct"])
        print(json.dumps({"cell": cell.name, "summary": summary}),
              flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                for line in lines:
                    f.write(json.dumps(line) + "\n")
    ctl.barrier()
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
