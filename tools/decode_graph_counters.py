"""One benchmark run with the CUDA-graph decode's counters read.

    python3 tools/decode_graph_counters.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell as ``perfbench/host_split.py`` runs it (the program's host
spans on, their split under ``host``), and adds under ``decode_graphs`` in
the result line the stage programs' counters (``StagePrograms``:
``decode_graph_replays``, ``decode_eager``, ``decode_graph_captures``,
``decode_graph_capture_s``, and the rows and positions the workspace
holds) as the warm-up left them and as the window left them, and the
share of the window's dense decode stage batches served by replay.  Run
from the checkout's root on a machine with a card.

It leans on the harness's internals: it wraps ``perfbench.harness.serve.
run_window`` and ``perfbench.harness.runner.run_cell`` over the wrappers
``host_split.install`` puts on them, and reads ``engine.programs``.  A
change to any of those breaks it; once the benchmark reads these counters
itself (in ``host_split.py`` or ``harness/record.py``), this tool goes.
"""
from time import perf_counter

PROCESS_START = perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import host_split  # noqa: E402

COUNTERS = ("decode_graph_replays", "decode_eager", "decode_graph_captures",
            "decode_graph_capture_s")


def counters(programs) -> dict:
    ws = programs.decode_graphs.workspace
    return dict({name: getattr(programs, name) for name in COUNTERS},
                workspace_rows=ws.rows, workspace_max_len=ws.max_len)


def install(seen: dict) -> None:
    """Snapshots of the counters around the window, added to ``run_cell``'s
    result (over ``host_split.install``'s patches)."""
    from perfbench.harness import runner, serve

    real_window, real_run = serve.run_window, runner.run_cell

    def run_window(engine, *a, **k):
        seen["warm_up"] = counters(engine.programs)
        try:
            return real_window(engine, *a, **k)
        finally:
            seen["window"] = counters(engine.programs)

    def run_cell(*a, **k):
        result = real_run(*a, **k)
        checks = result.pop("checks")
        w, e = seen["warm_up"], seen["window"]
        replays = e["decode_graph_replays"] - w["decode_graph_replays"]
        eager = e["decode_eager"] - w["decode_eager"]
        result["decode_graphs"] = {
            "warm_up": w, "window": e,
            "window_replay_share": replays / (replays + eager) if replays + eager else None,
        }
        print(f"decode graphs: warm-up {w}; window end {e}; the window's dense decode batches "
              f"by replay {replays} of {replays + eager}", file=sys.stderr, flush=True)
        result["checks"] = checks
        return result

    serve.run_window, runner.run_cell = run_window, run_cell


def main(argv=None) -> int:
    host_split.bench_run.PROCESS_START = PROCESS_START
    host_split.bench_run._caches()
    from repro_torch.obs import HostSpans

    host_split.install(host_split.Capture(HostSpans()))
    install({})
    return host_split.bench_run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
