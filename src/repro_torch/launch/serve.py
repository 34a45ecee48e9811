"""Collaborative serving entry point of the port:
``python -m repro_torch.launch.serve --arch <id> [--device cpu]``.

Boots a reduced model with seeded random weights on ``--device`` (default
``cuda``), partitions it into stages over a small edge topology, and serves
Poisson request streams through the model with live early-exit
confidences.  Two control-plane modes, as in ``repro.launch.serve``:

  * default — the paper's slotted loop: one DTO-EE configuration phase
    before each slot's serve, capacities re-drawn between slots;
  * ``--reconfig-interval R`` and/or ``--scenario NAME`` — the online loop:
    one long serve during which telemetry feeds a ``ReconfigController``
    that re-plans p and the thresholds every R simulated seconds while the
    scenario perturbs the live environment.

``--trace-out trace.json`` writes the serve (the last slot in slotted mode)
as Chrome-trace/Perfetto JSON; ``--stats-report report.json`` writes its
``ServeStats.report()`` (summary, per-request delay decomposition, metrics).

The flags are those of ``repro.launch.serve`` plus ``--device``; e.g. on
the CPU: ``python -m repro_torch.launch.serve --device cpu --cache-layout
paged --block-size 3 --gen-len 4``, or ``... --device cpu --scenario
slowdown --reconfig-interval 0.25 --trace-out t.json --stats-report r.json``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.control import (
    SCENARIO_NAMES,
    ControllerConfig,
    ReconfigController,
    Telemetry,
    TelemetryConfig,
    get_scenario,
)
from repro_torch.core.profiles import profile_from_arch
from repro_torch.core.thresholds import synthetic_validation
from repro_torch.core.topology import NetworkSpec, build_edge_network, with_resampled_capacities
from repro_torch.core.types import DtoHyperParams
from repro_torch.data import RequestConfig, poisson_requests
from repro_torch.models import model as model_lib
from repro_torch.obs import MetricsCollector, SpanTracer, write_chrome_trace
from repro_torch.serving import CollaborativeEngine
from repro_torch.serving.engine import resolve_device


def _observers(args):
    """(tracer, metrics) when an observability flag asked for them."""
    if args.trace_out is None and args.stats_report is None:
        return None, None
    return SpanTracer(), MetricsCollector()


def _write_obs(args, stats) -> None:
    if args.trace_out and stats.trace is not None:
        write_chrome_trace(args.trace_out, stats.trace)
        print(f"trace: {args.trace_out}", flush=True)
    if args.stats_report:
        with open(args.stats_report, "w") as f:
            json.dump(stats.report(), f, indent=1)
        print(f"stats report: {args.stats_report}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--slot-seconds", type=float, default=5.0)
    ap.add_argument("--requests-per-slot", type=int, default=24)
    ap.add_argument("--num-eds", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=8,
                    help="per-replica micro-batch width for the data plane")
    ap.add_argument("--gen-len", type=int, default=1,
                    help="tokens decoded per request (1 = single-shot classification)")
    ap.add_argument("--decode-mode", choices=("cached", "stateless"), default=None,
                    help="cached = slot-resident KV caches + continuous batching; "
                    "stateless = re-prefill baseline (default: cached iff gen-len > 1)")
    ap.add_argument("--num-slots", type=int, default=None,
                    help="cache slots per replica ring (default: 2 * batch size)")
    ap.add_argument("--cache-layout", choices=("dense", "paged"), default="dense",
                    help="slot-store memory layout: dense max_len arenas or a paged block pool")
    ap.add_argument("--block-size", type=int, default=16,
                    help="tokens per KV block under --cache-layout paged")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV blocks per replica pool under --cache-layout paged")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable prompt-prefix block sharing under --cache-layout paged")
    ap.add_argument("--reconfig-interval", type=float, default=None, metavar="SECONDS",
                    help="the online control plane: one long serve in which a ReconfigController "
                    "re-plans p and the thresholds from live telemetry every SECONDS of "
                    "simulated time")
    ap.add_argument("--reconfig-rounds", type=int, default=30,
                    help="DTO-EE rounds per online configuration phase (decision time = "
                    "rounds x 2 ms)")
    ap.add_argument("--scenario", choices=SCENARIO_NAMES, default=None,
                    help="perturb the live environment mid-serve: 'burst', 'slowdown', 'link' or "
                    "'failure' (needs --gen-len 1); implies the online serve mode")
    ap.add_argument("--batch-policy", choices=("fifo", "threshold"), default="fifo",
                    help="batch formation: 'fifo' (arrival order) or 'threshold' "
                    "(threshold-aware packing; token-identical outputs)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON of the serve (the last slot in "
                    "slotted mode) to PATH")
    ap.add_argument("--stats-report", default=None, metavar="PATH",
                    help="write the ServeStats.report() JSON (summary, delay decomposition, "
                    "metrics) of the traced serve to PATH")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model_lib.init_params(cfg, gen, device)
    profile = profile_from_arch(cfg)
    topo = build_edge_network(
        seed=args.seed, profile=profile, spec=NetworkSpec(num_eds=args.num_eds, es_per_stage=(3, 4))
    )
    exit_profile = synthetic_validation(seed=args.seed + 1, profile=profile)
    engine = CollaborativeEngine(
        params, cfg, topo, profile, exit_profile, DtoHyperParams(), seed=args.seed, device=device
    )

    rng = np.random.default_rng(args.seed)
    rcfg = RequestConfig(arrival_rate=args.requests_per_slot / args.slot_seconds, seed=args.seed)
    serve_kw = dict(
        batch_size=args.batch_size,
        gen_len=args.gen_len,
        decode_mode=args.decode_mode,
        num_slots=args.num_slots,
        cache_layout=args.cache_layout,
        block_size=args.block_size,
        num_blocks=args.num_blocks,
        prefix_sharing=not args.no_prefix_sharing,
        batch_policy=args.batch_policy,
    )

    if args.reconfig_interval is not None or args.scenario is not None:
        # online mode: one long serve, closed-loop reconfiguration mid-flight
        engine.configuration_phase()
        horizon = args.slots * args.slot_seconds
        reqs = poisson_requests(cfg, rcfg, horizon)
        prompts = [tok for _, tok in reqs][: args.requests_per_slot * args.slots]
        span = len(prompts) / rcfg.arrival_rate
        telemetry = Telemetry(engine.topo, TelemetryConfig(window_s=args.slot_seconds / 2))
        controller = None
        if args.reconfig_interval is not None:
            controller = ReconfigController(
                telemetry,
                ControllerConfig(interval=args.reconfig_interval, rounds=args.reconfig_rounds),
            )
        scenario = None
        if args.scenario is not None:
            scenario = get_scenario(args.scenario, engine.topo, p=engine.p, horizon=span,
                                    seed=args.seed)
        tracer, metrics = _observers(args)
        stats = engine.serve(
            prompts, duration=horizon, arrival_rate=rcfg.arrival_rate, scenario=scenario,
            controller=controller, telemetry=telemetry, tracer=tracer, metrics=metrics,
            **serve_kw,
        )
        s = stats.summary()
        cap = ", ".join(f"{v}: {mu:.1f}" for v, mu in sorted(s["capacity_estimates"].items()))
        print(
            f"online: {s['num_completed']} done  "
            f"mean_delay {s['mean_delay']*1e3:.1f}ms  "
            f"std {s['delay_std']*1e3:.1f}ms  p95 {s['p95_delay']*1e3:.1f}ms  "
            f"reconfigs {s['num_reconfigs']}  resubmitted {s['resubmitted']}  "
            f"padded waste {s['padded_row_frac']*100:.1f}%  "
            f"exits {s['exit_histogram']}",
            flush=True,
        )
        print(f"capacity estimates (GFLOP/s): {cap}")
        _write_obs(args, stats)
        print("done")
        return

    stats = None
    for slot in range(args.slots):
        engine.configuration_phase()
        reqs = poisson_requests(cfg, rcfg, args.slot_seconds)
        prompts = [tok for _, tok in reqs][: args.requests_per_slot]
        # observability rides on the LAST slot only: one trace, one serve
        tracer, metrics = _observers(args) if slot == args.slots - 1 else (None, None)
        stats = engine.serve(
            prompts,
            duration=args.slot_seconds,
            arrival_rate=rcfg.arrival_rate,
            tracer=tracer,
            metrics=metrics,
            **serve_kw,
        )
        s = stats.summary()
        paged_info = (
            f"  blocks {s['block_occupancy_peak']*100:.0f}% peak  "
            f"prefix hits {s['prefix_hit_rate']*100:.0f}%"
            if args.cache_layout == "paged"
            else ""
        )
        print(
            f"slot {slot}: {s['num_completed']} done  "
            f"{s['generated_tokens']} tokens  "
            f"mean_delay {s['mean_delay']*1e3:.1f}ms  "
            f"p95 {s['p95_delay']*1e3:.1f}ms  "
            f"padded waste {s['padded_row_frac']*100:.1f}%  "
            f"exits {s['exit_histogram']}  thresholds {engine.thresholds}"
            f"{paged_info}",
            flush=True,
        )
        # dynamic environment: replicas throttle between slots (paper §4.3)
        engine.update_topology(with_resampled_capacities(engine.topo, rng))

    if stats is not None:
        _write_obs(args, stats)
    print("done")


if __name__ == "__main__":
    main()
