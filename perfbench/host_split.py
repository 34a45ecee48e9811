"""One run of one cell as ``run.py`` runs it, with the program's host spans
on (``repro_torch.obs.HostSpans``) from the window's start, and their
readings (``harness/host.py``) added to the result line under ``host``.

    python3 perfbench/host_split.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 1`` the traced span also drops a clock marker as the
profiler starts and one before it stops, and joins the program's spans to
its device trace.  Standard error gets the window's split, the traced
span's idle gaps by program span, and the kernels ``nvcc`` built in this
process against those loaded from the build cache.
"""
from time import perf_counter

PROCESS_START = perf_counter()

import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run as bench_run  # noqa: E402


class Capture:
    """What the patched harness keeps for the readings after ``run_cell``."""

    def __init__(self, host_spans):
        self.host_spans = host_spans
        self.window = None  # (start s, seconds) on perf_counter
        self.span = None  # the MarkedSpan of a traced run


def readings(cap: Capture, cell: dict, log) -> dict:
    from perfbench.harness import host
    from repro_torch.kernels import build

    t0, seconds = cap.window
    lo = round(t0 * 1e9)
    hi = (round((t0 + seconds) * 1e9) if math.isfinite(seconds)
          else max(s.t1 for s in cap.host_spans.spans))
    out = {"window": host.window_split(cap.host_spans, lo, hi)}
    w = out["window"]
    parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(w["self_ms_per_batch"].items(),
                                                          key=lambda kv: -kv[1]))
    log(f"host spans over the window: {w['batches']} stage batches ({w['batches_per_s']:.2f}/s), "
        f"stage {w['stage_host_ms']} ms, engine {w['engine_host_ms']} ms a batch, head pull "
        f"{w['head_pull_ms']} ms a head batch, covering {100 * w['coverage']:.2f}% of the "
        f"window; self ms a batch: {parts}")
    if cap.span is not None and cap.span.join is not None:
        j = out["span"] = cap.span.join
        log(f"host spans over the traced span: clock drift {j['clock_drift_ms']:.4f} ms; idle "
            f"{j['idle_s']:.4f} s (profiler {j['profiler_idle_s']:.4f} s), in engine "
            f"{j['idle_in_engine']}%; {j['launches']} launches, {j['launches_per_batch']} a "
            f"batch in stage.* over {j['batches']} batches, in stage.* or engine.input "
            f"{j['launches_in_stage_or_input']}; by span {j['launches_by_span']}")
        for label, s in j["idle_gaps_program"]:
            log(f"  idle {s:.6f} s in {label}")
    built = {n: round(s, 1) for n, (s, _) in build.build_reports.items()}
    loaded = [n for n in cell["mix"].get("kernels", []) if n not in built]
    out["kernels"] = {"built_s": built, "loaded": loaded}
    log(f"kernels built by nvcc in this process (s): {built or 'none'}; loaded from the build "
        f"cache: {', '.join(loaded) or 'none'}")
    return out


def install(cap: Capture) -> None:
    """Spans on at the window's start, a marked traced span, and the
    readings added to ``run_cell``'s result."""
    from perfbench.harness import host, runner, serve

    real_window, real_run = serve.run_window, runner.run_cell

    def run_window(engine, obs, mix, vocab, seed, seconds, *a, **k):
        engine.host_spans = cap.host_spans
        t0 = real_window(engine, obs, mix, vocab, seed, seconds, *a, **k)
        cap.window = (t0, seconds)
        return t0

    def trace_span(seconds, device):
        cap.span = host.MarkedSpan(seconds, device, cap.host_spans)
        return cap.span

    def run_cell(cell, seed, seconds, trace, device, process_start, log=None, **k):
        log = log or (lambda line: print(line, file=sys.stderr, flush=True))
        result = real_run(cell, seed, seconds, trace, device, process_start, log=log, **k)
        checks = result.pop("checks")
        result["host"] = readings(cap, cell, log)
        result["checks"] = checks
        return result

    serve.run_window, runner.TraceSpan, runner.run_cell = run_window, trace_span, run_cell


def main(argv=None) -> int:
    bench_run.PROCESS_START = PROCESS_START
    bench_run._caches()
    sys.path[:0] = [str(ROOT / "src")]
    from repro_torch.obs import HostSpans

    install(Capture(HostSpans()))
    return bench_run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
