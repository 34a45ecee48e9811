"""The readings a cell's limits are set from: the program's numbers and the
fp8 control's, on many seeds, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2] [--seconds S]

For each seed, a run of the cell as ``run.py`` makes it (set-up with that
seed's weights, the same check), with a window of one whole slot, so the
mix's longest requests finish, or with ``--seconds`` the run's own window
(a mix whose slot outlasts the window: its requests in flight are judged as
a run judges them), and, for a seed of ``--control-seeds`` (default: every
seed), the fp8 control's numbers on the same sample and whether the cell's
limits pass it (``control.correct``, which has to be false).  One JSON line
a seed; then, per number, the lower reading (the program's largest), the
upper (the control's smallest) and their ratio.  The benchmark's own runs
never run this.
"""
import argparse
import json
import sys
from pathlib import Path
from time import perf_counter

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", default=None, help="comma-separated (default: --seeds)")
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window (default: one whole slot)")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench.harness import bench
    from perfbench.harness.runner import run_cell
    from perfbench.run import _caches

    _caches()
    torch.set_num_threads(1)  # as run.py runs the engine
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 1
    cell = bench.cell(args.workload, ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = set(seeds if args.control_seeds is None
                  else (int(s) for s in args.control_seeds.split(",")))
    rows = []
    for seed in seeds:
        t = perf_counter()
        r = run_cell(cell, seed, float("inf") if args.seconds is None else args.seconds, False,
                     torch.device("cuda", 0), t,
                     log=lambda line: print(line, file=sys.stderr, flush=True),
                     max_slots=1 if args.seconds is None else None, control=seed in control)
        row = {"seed": seed, "correct": r["correct"],
               "program": {k: v["value"] for k, v in r["checks"].items()},
               "control": r.get("control"), "metrics": r["metrics"],
               "seconds": perf_counter() - t,
               "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    for k in ("token_gap", "conf_log_err"):
        lower = max(row["program"][k] for row in rows)
        ctl = [row["control"][k] for row in rows if row["control"]]
        upper = min(ctl) if ctl else float("nan")
        print(json.dumps({"number": k, "lower": lower, "upper": upper,
                          "ratio": upper / lower if lower else float("inf")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
