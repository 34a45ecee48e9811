"""Collaborative serving entry point of the port:
``python -m repro_torch.launch.serve --arch <id> [--device cpu]``.

Boots a reduced model with seeded random weights on ``--device`` (default
``cuda``), partitions it into stages over a small edge topology, runs a
DTO-EE configuration phase before each time slot, and serves Poisson
request streams through the model with live early-exit confidences.
Capacities are re-drawn between slots (the paper's dynamic environment).

The flags are those of ``repro.launch.serve`` plus ``--device``; e.g. the
paged layout on the CPU:
``python -m repro_torch.launch.serve --device cpu --cache-layout paged
--block-size 3 --gen-len 4``.  The online control plane
(``--reconfig-interval``, ``--scenario``) and the observability outputs
(``--trace-out``, ``--stats-report``) are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.profiles import profile_from_arch
from repro_torch.core.thresholds import synthetic_validation
from repro_torch.core.topology import NetworkSpec, build_edge_network, with_resampled_capacities
from repro_torch.core.types import DtoHyperParams
from repro_torch.data import RequestConfig, poisson_requests
from repro_torch.models import model as model_lib
from repro_torch.serving import CollaborativeEngine
from repro_torch.serving.engine import resolve_device


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
                    help="online control plane (not ported yet)")
    ap.add_argument("--reconfig-rounds", type=int, default=30,
                    help="DTO-EE rounds per online configuration phase (not ported yet)")
    ap.add_argument("--scenario", default=None,
                    help="live environment perturbation (not ported yet)")
    ap.add_argument("--batch-policy", choices=("fifo", "threshold"), default="fifo",
                    help="batch formation: 'fifo' (arrival order) or 'threshold' "
                    "(threshold-aware packing; token-identical outputs)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="Perfetto trace of the serve (not ported yet)")
    ap.add_argument("--stats-report", default=None, metavar="PATH",
                    help="ServeStats.report() JSON (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.reconfig_interval is not None or args.scenario is not None:
        raise NotImplementedError(
            "the online control plane is not ported yet (ROADMAP: next slices, obs/ and control/)")
    if args.trace_out is not None or args.stats_report is not None:
        raise NotImplementedError(
            "tracing and serve reports are not ported yet (ROADMAP: next slices, obs/ and control/)")

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
    for slot in range(args.slots):
        engine.configuration_phase()
        reqs = poisson_requests(cfg, rcfg, args.slot_seconds)
        prompts = [tok for _, tok in reqs][: args.requests_per_slot]
        stats = engine.serve(
            prompts,
            duration=args.slot_seconds,
            arrival_rate=rcfg.arrival_rate,
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
    print("done")


if __name__ == "__main__":
    main()
