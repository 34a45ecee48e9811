"""The timed path: the program's ``CollaborativeEngine`` built from a
configuration file and a mix file, warmed up, and driven slot by slot as
``repro_torch.launch.serve``'s slotted loop does (one DTO-EE configuration
phase, then one ``serve`` of the slot's requests, the replicas' capacities
re-drawn between slots).

The deployment (topology, capacities and the engine's own draws: arrivals
on its simulated clock, routing) comes from the mix's ``deployment_seed``,
the same for every run seed; the run seed makes the weights and the
prompts.
"""
from __future__ import annotations

import contextlib
from time import perf_counter

import numpy as np
import torch

from perfbench.harness import traffic
from perfbench.harness.record import Observer, WindowClosed
from perfbench.harness.weights import make_weights

# the program's ArchConfig fields a configuration file's ``port`` group sets
_ARCH_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
              "head_dim", "norm", "act", "ffn", "qkv_bias", "rope_theta", "num_stages")


def arch_config(model: dict):
    from repro_torch.configs.base import ArchConfig

    kw = {k: model[k] for k in _ARCH_KEYS}
    return ArchConfig(name=model["name"], family="dense", period=("attn",),
                      exit_stages=tuple(model["exit_stages"]), **kw)


def build_kernels(names) -> float:
    """Build (or load) the named CUDA kernels, all nvcc runs at once;
    returns the seconds it took."""
    from repro_torch.kernels import build

    t = perf_counter()
    build.build_all(names)
    for n in names:
        build.load(n)
    return perf_counter() - t


def build_engine(model: dict, mix: dict, seed: int, device):
    """(engine, weights): the benchmark's weights for ``seed`` and the
    engine over the mix's deployment."""
    from repro_torch.core.profiles import profile_from_arch
    from repro_torch.core.thresholds import synthetic_validation
    from repro_torch.core.topology import NetworkSpec, build_edge_network
    from repro_torch.core.types import DtoHyperParams
    from repro_torch.models import model as model_lib
    from repro_torch.serving import CollaborativeEngine

    cfg = arch_config(model)
    weights = make_weights(model_lib.init_params(cfg, None, "meta"), seed, device)
    profile = profile_from_arch(cfg)
    net = mix["network"]
    dep = int(mix["deployment_seed"])
    topo = build_edge_network(seed=dep, profile=profile, spec=NetworkSpec(
        num_eds=net["num_eds"], es_per_stage=tuple(net["es_per_stage"])))
    exit_profile = synthetic_validation(seed=dep + 1, profile=profile)
    engine = CollaborativeEngine(weights, cfg, topo, profile, exit_profile, DtoHyperParams(),
                                 seed=dep, device=device)
    return engine, weights


def serve_kwargs(mix: dict, gen_len: int | None = None) -> dict:
    return dict(arrival_rate=float(mix["arrival_rate"]), duration=1.0,
                batch_size=int(mix["batch_size"]),
                gen_len=int(mix["gen_len"] if gen_len is None else gen_len),
                decode_mode=mix["decode_mode"], num_slots=mix.get("num_slots"),
                cache_layout="dense")


def warm_up(engine, mix: dict, vocab: int) -> None:
    """One short serve over the shapes the window uses: the slot stores'
    size, the longest prompt's activations, every padded batch size."""
    warm_gen = min(2, int(mix["gen_len"]))
    engine.configuration_phase()
    engine.serve(traffic.warmup_prompts(mix, vocab, warm_gen), **serve_kwargs(mix, warm_gen))
    if engine.programs.device.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def observed(obs: Observer):
    """Route every head output to ``obs`` and keep each slot's ServeStats
    (also of a serve the window cuts), for the duration of the window."""
    from repro_torch.kernels import ops
    from repro_torch.serving import engine as engine_mod

    real_exit, real_stats = ops.exit_confidence, engine_mod.ServeStats

    def exit_confidence(h, w):
        out = real_exit(h, w)
        obs.head_output(*out)
        return out

    def serve_stats(*a, **k):
        s = real_stats(*a, **k)
        obs.stats[obs.slot] = s
        return s

    ops.exit_confidence, engine_mod.ServeStats = exit_confidence, serve_stats
    try:
        yield
    finally:
        ops.exit_confidence, engine_mod.ServeStats = real_exit, real_stats


def run_window(engine, obs: Observer, mix: dict, vocab: int, seed: int, seconds: float,
               extra_seconds: float = 0.0, max_slots: int | None = None) -> float:
    """Serve slot after slot until ``seconds`` (plus ``extra_seconds``, a
    traced span) have passed, or ``max_slots`` slots have ended; returns
    the window's start on the host's clock."""
    from repro_torch.core.topology import with_resampled_capacities

    cap_rng = np.random.default_rng(int(mix["deployment_seed"]) + 2)
    kw = serve_kwargs(mix)
    t0 = perf_counter()
    obs.window_end = t0 + seconds
    # a traced span ends the serve itself; the deadline only stops a span
    # that never ends (no stage batch comes)
    obs.deadline = t0 + seconds + (2 * extra_seconds + 60 if extra_seconds else 0)
    slot = 0
    with observed(obs):
        try:
            while max_slots is None or slot < max_slots:
                engine.configuration_phase()
                prompts = traffic.slot_prompts(mix, vocab, seed, slot)
                obs.begin_slot(slot, prompts)
                engine.serve(prompts, metrics=obs, **kw)
                slot += 1
                engine.update_topology(with_resampled_capacities(engine.topo, cap_rng))
                if perf_counter() > obs.deadline:
                    break
        except WindowClosed:
            pass
    if engine.programs.device.type == "cuda":
        torch.cuda.synchronize()
    return t0
