"""Readings for the limits of a cell's comparison: its numbers on sound
runs of the program over many seeds (the lower readings) and on its
control (the upper readings), each run a short window at the cell's own
sizes, all in one process. One JSON line a run.

    python3 -m benchmark.readings --workload <cell> --seconds <s> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--control fp8] [--fault unchanged]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys

from benchmark import run as R


def one(workload: str, seed: int, seconds: float, **options) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = R.main(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds)], **options)
    lines = buf.getvalue().strip().splitlines()
    return json.loads(lines[-1]) if rc == 0 and lines else {"rc": rc}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--control", default=None, help="the reference's precision in the program's place")
    p.add_argument("--fault", default=None, help="a fault planted in the timed path, on the control seeds")
    args = p.parse_args(argv)
    control = {"control": args.control} if args.control else {}
    if args.fault:
        control["fault"] = args.fault
    for kind, seeds, options in (("program", args.seeds, {}), ("control", args.control_seeds, control)):
        for seed in (int(s) for s in seeds.split(",") if s):
            out = one(args.workload, seed, args.seconds, **options)
            print(json.dumps({"kind": kind, "seed": seed, "options": options, "rc": out.get("rc", 0),
                              **{k: v for k, v in out.items() if k not in ("device", "breakdown")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
