"""One run of one cell: set-up, the window, the traced span, the metrics,
and the check of what the window served.

``run_cell`` is the whole run but for the command line and the look for a
chip (``perfbench/run.py``), so a test can drive it on the CPU at a small
size.
"""
from __future__ import annotations

import gc
import sys
from time import perf_counter

import torch

from perfbench.harness import bench, check, serve, traffic
from perfbench.harness.record import Observer, Record, percentile
from perfbench.harness.trace import TraceSpan


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             process_start: float, log=None, max_slots: int | None = None,
             control: bool = False) -> dict:
    """The run's result line (a dict): ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, with ``trace`` also ``breakdown``,
    and last ``checks``.  ``log`` takes the lines for standard error.

    For the readings limits are set from (``perfbench/calibrate.py``):
    ``max_slots`` ends the window after that many slots, and ``control``
    adds the fp8 control's numbers on the same sample, and its verdict
    under the cell's limits (``control``)."""
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    t_imports = perf_counter()
    model, mix = cell["config"]["port"], cell["mix"]
    vocab = int(model["vocab_size"])
    cuda = _cuda(device)
    if cuda and mix.get("kernels"):
        log(f"kernels built or loaded in {serve.build_kernels(mix['kernels']):.1f} s")
    t = perf_counter()
    engine, weights = serve.build_engine(model, mix, seed, device)
    t_warm = perf_counter()
    serve.warm_up(engine, mix, vocab)
    log(f"set-up: imports {t_imports - process_start:.2f} s, weights and engine "
        f"{t_warm - t:.2f} s, warm-up {perf_counter() - t_warm:.2f} s")
    head_stages = list(model["exit_stages"]) + [model["num_stages"]]
    obs = Observer(head_stages)
    span = None
    profile_s = float(mix["trace"]["seconds"]) if trace else 0.0
    setup_s = perf_counter() - process_start
    if trace:
        span = TraceSpan(profile_s, device)
        obs.span = span
        with span.installed(engine):
            t0 = serve.run_window(engine, obs, mix, vocab, seed, seconds, profile_s)
    else:
        t0 = serve.run_window(engine, obs, mix, vocab, seed, seconds, max_slots=max_slots)
    window_end = perf_counter()
    summary = None
    if span is not None:
        summary = span.summary()
        if summary is None:
            raise RuntimeError("the traced span did not run: the serve ended before it did")
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rec = Record(obs, t0, seconds, setup_s, model, summary)

    metrics = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = bench.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if rec.task_ms:
        log(f"task latency: median {percentile(rec.task_ms, 50):.3f} ms, p95 "
            f"{percentile(rec.task_ms, 95):.3f} ms over {len(rec.task_ms)} tasks")
    if seconds < float("inf"):
        bins = [0] * max(1, int(seconds // 5))
        for b in rec.batches:
            bins[min(int((b[0] - t0) // 5), len(bins) - 1)] += 1
        log(f"stage batches in each 5 s of the window: {bins}")
    log(f"window {seconds:.1f} s: {len(rec.tokens)} tokens, {len(rec.exits)} requests retired, "
        f"{len(rec.batches)} stage batches; set-up {setup_s:.2f} s; served until "
        f"{window_end - t0:.2f} s")
    if summary is not None:
        span_rate = summary["batches"] / summary["window_s"]
        win_rate = len(rec.batches) / seconds
        log(f"traced span {summary['window_s']:.2f} s: {summary['batches']} stage batches "
            f"({span_rate:.2f}/s against the window's {win_rate:.2f}/s), device busy "
            f"{summary['busy_s']:.4f} s; op calls {summary['calls']}; device events with no "
            f"launch found {summary['unmatched']}; kernels by op {summary['op_kernels']}")

    # the check: the program's state goes first, then the reference runs
    reqs = check.served_requests(obs, int(mix["gen_len"]), int(model["num_stages"]))
    attempted = len(rec.exits)
    del engine, obs, span
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sampled = check.sample(reqs, model, mix["check"], seed)
    t_check = perf_counter()
    numbers = check.compare(weights, model, mix, sampled,
                            lambda slot: traffic.slot_prompts(mix, vocab, seed, slot), device,
                            control=control)
    if not sampled:
        numbers["missing"] += 1  # nothing served: nothing to show correct
    correct, shown = check.verdict(numbers, cell["limits"])
    log(f"check: {len(sampled)} of {len(reqs)} requests served ("
        f"{sum(r['finished'] for r in sampled)} finished), "
        f"{sum(len(r['gen']) for r in sampled)} served tokens, "
        f"{sum(len(h) for r in sampled for h in r['heads'].values())} head outputs, "
        f"{perf_counter() - t_check:.1f} s")

    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": metrics}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in summary["device_ops"]],
                               "idle_gaps": [list(x) for x in summary["idle_gaps"]]}
    result["device"] = dev
    if control:
        # the control, judged by the cell's own limits (it produces every
        # output, so nothing of it is missing)
        ctl = {k: numbers[f"control_{k}"] for k in ("token_gap", "conf_log_err")}
        ctl["correct"], _ = check.verdict(dict(ctl, missing=0), cell["limits"])
        result["control"] = ctl
    result["checks"] = shown
    return result
