"""Collaborative serving engine: the paper's system with a real model inside.

The counterpart of ``repro.serving.engine`` for the dense and paged slot
layouts, in both decode modes.  A model is partitioned into
``cfg.num_stages`` stages; each stage ``h`` is served by ``n_h`` logical
replicas.  The engine routes each request hop by hop by sampling the DTO-EE
offloading strategy ``p``, runs the REAL stage forwards on the device (exit
decisions use the model's branch confidences against the thresholds C), and
advances a simulated clock with M/D/1 service at each replica, so the
reported ``delays`` follow the queueing model the optimizer uses.  The delays are simulated; the
device work is real.

Data plane: ``serve(..., gen_len=N)`` decodes up to N tokens per request.
The first pass is a prefill hop chain; in cached mode each stage writes its
KV caches into a slot of the replica's resident store, the route is pinned
per stage (``Request.path``), and every later token is a one-token cached
step through the flash-decode kernel.  ``cache_layout="paged"`` keeps the
K/V in a per-replica pool of blocks instead, reached through per-request
block tables (``serving.paging``), with prompt-prefix sharing; its decode
runs the paged flash-decode kernel.  ``decode_mode="stateless"`` re-runs
the padded prefix instead.  Replicas own rings of cache slots; new prompts
are admitted into running batches at stage boundaries, and early-exited
rows retire without stalling the batch (continuous batching).  Exit and
final heads go through the fused ``exit_confidence`` kernel.

Hidden states travel between replicas as device tensors (each request
keeps its row of the stage output; a batch is assembled with ``torch.cat``);
the confidences and tokens of a batch come to the host once.

Observers and the online control plane, as in the reference: a
``telemetry`` sink, a ``tracer`` (span trees, the roofline join's wall
times) and ``metrics`` subscribe to one instrumentation stream
(``obs.stream``); a ``controller`` re-plans DTO-EE mid-serve from the
telemetry; a ``scenario`` perturbs a private copy of the topology
(bursts, slowdowns, link degradation, fail-stop).  With no observer the
stream is None and the serve adds no host work and no device sync.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from time import perf_counter
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import dto_ee
from repro_torch.core import topology as topo_lib
from repro_torch.core.simulator import RoutingCdf
from repro_torch.core.thresholds import ExitProfile
from repro_torch.core.types import DtoHyperParams, ModelProfile, Topology
from repro_torch.models import model as model_lib
from repro_torch.obs.attribution import decompose
from repro_torch.obs.stream import build_stream
from repro_torch.runtime import elastic
from repro_torch.serving import steps
from repro_torch.serving.batching import (
    ExitPredictor,
    Request,
    ShapeBucketBatcher,
    SlotRing,
    batch_tokens,
    pack_decode_batch,
    padded_batch_size,
    pow2_floor,
)
from repro_torch.serving.paging import BlockAllocator


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was asked for but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def _thinned_arrivals(
    rng: np.random.Generator, base_rate: float, factor, f_max: float, n: int
) -> np.ndarray:
    """Non-homogeneous Poisson arrival times for ``n`` requests by thinning:
    candidates arrive at ``base_rate * f_max`` and are accepted with
    probability ``factor(t) / f_max`` (the scenario's piecewise arrival-rate
    modulation, e.g. a burst window)."""
    lam = base_rate * max(f_max, 1e-12)
    out = np.empty(n, np.float64)
    t = 0.0
    k = 0
    while k < n:
        t += rng.exponential(1.0 / lam)
        if rng.random() * f_max <= factor(t):
            out[k] = t
            k += 1
    return out


# ---------------------------------------------------------------------------
# Stage programs
# ---------------------------------------------------------------------------


class StagePrograms:
    """Per-stage forwards and fused heads of a partitioned model on one
    device.  The parameters are moved to ``device`` (default ``cuda``)."""

    def __init__(self, params: Any, cfg: ArchConfig, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = model_lib.params_to(params, self.device)

    def embed(self, tokens: np.ndarray) -> torch.Tensor:
        toks = torch.as_tensor(np.asarray(tokens, np.int64), device=self.device)
        return steps.embed_step(self.params, toks)

    def run_stage(self, stage_idx: int, x: torch.Tensor) -> torch.Tensor:
        """Forward hidden states through stage ``stage_idx`` (1-indexed)."""
        return steps.stage_forward(self.params, x, self.cfg, stage_idx)

    def stage_prefill(self, stage_idx: int, x: torch.Tensor, max_len: int):
        """(x_out, stage caches [n_periods, B, max_len, ...]) for one stage."""
        return steps.stage_prefill(self.params, x, self.cfg, stage_idx, max_len)

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(idx, dtype=torch.int64, device=self.device)

    def stage_decode(self, stage_idx: int, x, slot_caches, slots: np.ndarray) -> torch.Tensor:
        """One cached token per row against the replica's store (in place)."""
        return steps.stage_decode(self.params, x, slot_caches, self._index(slots), self.cfg,
                                  stage_idx)

    def slot_write(self, slot_caches, new_caches, slots: np.ndarray) -> None:
        steps.slot_write(slot_caches, new_caches, self._index(slots))

    def init_slot_caches(self, stage_idx: int, num_slots: int, max_len: int):
        return model_lib.init_stage_slot_caches(
            self.cfg, stage_idx, num_slots, max_len, device=self.device
        )

    # -- paged layout -------------------------------------------------------
    def init_paged_slot_caches(self, stage_idx: int, num_slots: int, num_blocks: int,
                               block_size: int, max_len: int):
        """``(pool, state)`` of one replica; both counts include the trash row."""
        return model_lib.init_stage_paged_caches(
            self.cfg, stage_idx, num_slots, num_blocks, block_size, max_len, device=self.device
        )

    def paged_slot_write(self, pool, state, new_caches, wtab: np.ndarray,
                         slots: np.ndarray) -> None:
        steps.paged_slot_write(pool, state, new_caches, self._index(wtab), self._index(slots))

    def paged_stage_decode(self, stage_idx: int, x, pool, state, tables: np.ndarray,
                           slots: np.ndarray, seq_len: int) -> torch.Tensor:
        """One cached token per row through the block tables (pool and state
        updated in place)."""
        tab = torch.as_tensor(tables, dtype=torch.int32, device=self.device)
        return steps.paged_stage_decode(self.params, x, pool, state, tab, self._index(slots),
                                        self.cfg, stage_idx, seq_len)

    def block_copy(self, pool, src: np.ndarray, dst: np.ndarray) -> None:
        steps.block_copy(pool, self._index(src), self._index(dst))

    def exit_head(self, stage_idx: int, x_last: torch.Tensor):
        """(confidence, token) of the exit branch after stage ``stage_idx``."""
        return steps.exit_head_step(self.params, x_last, self.cfg, stage_idx)

    def final_head(self, x_last: torch.Tensor):
        """(confidence, token) of the final head — fused, no [B, vocab] logits."""
        return steps.final_head_step(self.params, x_last, self.cfg)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeStats:
    delays: list = dataclasses.field(default_factory=list)
    exit_stage: list = dataclasses.field(default_factory=list)
    confidences: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)  # last emitted token
    rids: list = dataclasses.field(default_factory=list)
    gen_tokens: list = dataclasses.field(default_factory=list)  # full sequences
    arrivals: list = dataclasses.field(default_factory=list)
    dones: list = dataclasses.field(default_factory=list)
    num_batches: int = 0
    num_forward_rows: int = 0  # padded rows pushed through stage forwards
    num_real_rows: int = 0  # live rows among them (the rest is padding waste)
    peak_in_flight: int = 0
    # paged layout: prompt blocks served from the prefix map vs allocated,
    # pool occupancy sampled at every paged batch (per replica), and each
    # replica's allocator as the serve left it
    prefix_hit_blocks: int = 0
    prefix_total_blocks: int = 0
    block_occupancy: list = dataclasses.field(default_factory=list)
    allocators: dict = dataclasses.field(default_factory=dict)
    # online control plane: mid-serve strategy installs, failure re-executions,
    # and the straggler monitor's end-of-serve capacity estimates per ES
    num_reconfigs: int = 0
    reconfig_times: list = dataclasses.field(default_factory=list)
    resubmitted: int = 0
    capacity_estimates: dict = dataclasses.field(default_factory=dict)
    # observability: the SpanTracer / MetricsCollector attached to the serve
    # (None when tracing was off)
    trace: Any = None
    metrics: Any = None

    def summary(self) -> dict:
        d = np.asarray(self.delays)
        es = np.asarray(self.exit_stage)
        total_tokens = int(sum(len(g) for g in self.gen_tokens))
        makespan = float(max(self.dones) - min(self.arrivals)) if self.dones else float("nan")
        nan = float("nan")
        out = {
            "num_completed": int(d.size),
            "mean_delay": float(d.mean()) if d.size else nan,
            "delay_std": float(d.std()) if d.size else nan,
            "p50_delay": float(np.percentile(d, 50)) if d.size else nan,
            "p95_delay": float(np.percentile(d, 95)) if d.size else nan,
            "p99_delay": float(np.percentile(d, 99)) if d.size else nan,
            "exit_histogram": {int(s): int((es == s).sum()) for s in np.unique(es)},
            "num_batches": self.num_batches,
            "num_forward_rows": self.num_forward_rows,
            "num_real_rows": self.num_real_rows,
            "padded_row_frac": (
                1.0 - self.num_real_rows / self.num_forward_rows if self.num_forward_rows else 0.0
            ),
            "generated_tokens": total_tokens,
            "sim_tokens_per_s": (
                total_tokens / makespan if makespan and makespan > 0 else nan
            ),
            "peak_in_flight": self.peak_in_flight,
            # paged-layout memory stats (zeros / nan under the dense layout)
            "prefix_hit_blocks": self.prefix_hit_blocks,
            "prefix_total_blocks": self.prefix_total_blocks,
            "prefix_hit_rate": (
                self.prefix_hit_blocks / self.prefix_total_blocks if self.prefix_total_blocks else 0.0
            ),
            "block_occupancy_mean": (
                float(np.mean(self.block_occupancy)) if self.block_occupancy else nan
            ),
            "block_occupancy_peak": (
                float(np.max(self.block_occupancy)) if self.block_occupancy else nan
            ),
            # online control plane
            "num_reconfigs": self.num_reconfigs,
            "resubmitted": self.resubmitted,
            "capacity_estimates": dict(self.capacity_estimates),
        }
        if self.trace is not None:
            dec = decompose(self.trace, self)
            out["delay_components"] = dec["mean_components_s"]
            out["per_stage_components"] = dec["per_stage"]
        return out

    def report(self) -> dict:
        """Machine-readable serve report: the summary plus, when a tracer
        was attached, the full per-request delay decomposition and, when a
        metrics collector was attached, its registry snapshot."""
        out = {"summary": self.summary()}
        if self.trace is not None:
            out["decomposition"] = decompose(self.trace, self)
        if self.metrics is not None:
            out["metrics"] = self.metrics.snapshot()
        return out

    def by_rid(self) -> dict[int, tuple[int, int]]:
        """rid -> (exit_stage, token); completion-order independent view."""
        return {r: (s, t) for r, s, t in zip(self.rids, self.exit_stage, self.tokens)}

    def sequences_by_rid(self) -> dict[int, tuple[int, tuple[int, ...]]]:
        """rid -> (exit_stage, full token sequence)."""
        return {r: (s, tuple(g)) for r, s, g in zip(self.rids, self.exit_stage, self.gen_tokens)}


class CollaborativeEngine:
    """End-to-end: Poisson arrivals -> DTO-EE routing -> staged model on
    ``device`` (default ``cuda``; pass ``device="cpu"`` to run on the CPU)."""

    def __init__(
        self,
        params: Any,
        cfg: ArchConfig,
        topo: Topology,
        profile: ModelProfile,
        exit_profile: ExitProfile,
        hyper: DtoHyperParams | None = None,
        seed: int = 0,
        device="cuda",
    ):
        if topo.num_stages != cfg.num_stages:
            raise ValueError("topology stages must match the model's stages")
        self.programs = StagePrograms(params, cfg, device)
        self.cfg = cfg
        self.topo = topo
        self.profile = profile
        self.exit_profile = exit_profile
        self.hyper = hyper or DtoHyperParams()
        self.rng = np.random.default_rng(seed)
        self.state = dto_ee.init_state(topo, profile, exit_profile)
        self._round_step = dto_ee.make_round_step(topo, profile, self.hyper)
        self.stage_to_branch = {s: b for b, s in enumerate(exit_profile.branch_stage[:-1])}
        # live capacity tracker: every stage batch folds its (GFLOPs, service
        # time) into the EWMA, the measurement half of the control loop
        self.straggler = elastic.StragglerMonitor.from_topology(topo)

    # -- control plane ------------------------------------------------------
    def update_topology(self, new_topo: Topology) -> None:
        """Capacities / arrival rates changed between slots; the offloading
        state (p, thresholds) warm-starts."""
        if new_topo.num_edges != self.topo.num_edges:
            raise ValueError("edge set changed; use runtime.elastic helpers first")
        self.topo = new_topo
        self._round_step = dto_ee.make_round_step(new_topo, self.profile, self.hyper)

    def configuration_phase(self, adapt_thresholds: bool = True) -> None:
        """One time-slot configuration update (Algorithm 3)."""
        res = dto_ee.run_configuration_phase(
            self.topo,
            self.profile,
            self.exit_profile,
            self.hyper,
            state=self.state,
            adapt_thresholds=adapt_thresholds,
            round_step=self._round_step,
        )
        self.state = res.state

    @property
    def p(self) -> np.ndarray:
        return self.state.carry.p.numpy().astype(np.float64)

    @property
    def thresholds(self) -> np.ndarray:
        return self.state.thresholds

    # -- data plane ---------------------------------------------------------
    def _stage_input(self, stage: int, reqs: list[Request], batch_size: int,
                     pad_to: int | None = None) -> torch.Tensor:
        """Assemble the padded [B, S, d] residual stream for one batch.

        ``pad_to`` right-pads the token batch to a fixed length (stateless
        decode passes: a fixed shape keeps every pass's reductions
        length-stable, so re-prefill matches the fixed-arena cached path).
        """
        if stage == 1:
            toks = batch_tokens(reqs, batch_size)
            if pad_to is not None and toks.shape[1] < pad_to:
                toks = np.pad(toks, ((0, 0), (0, pad_to - toks.shape[1])))
            return self.programs.embed(toks)
        return _cat_hidden(reqs, padded_batch_size(len(reqs), batch_size))

    def serve(
        self,
        prompts: list[np.ndarray],
        duration: float = 5.0,
        arrival_rate: float | None = None,
        batch_size: int = 1,
        gen_len: int = 1,
        decode_mode: str | None = None,
        num_slots: int | None = None,
        cache_layout: str = "dense",
        block_size: int = 16,
        num_blocks: int | None = None,
        prefix_sharing: bool = True,
        batch_policy: str = "fifo",
        controller=None,
        scenario=None,
        telemetry=None,
        tracer=None,
        metrics=None,
    ) -> ServeStats:
        """Serve ``prompts`` arriving as a Poisson stream at ``arrival_rate``
        (default: the topology's total external rate), as
        ``repro.serving.engine.CollaborativeEngine.serve`` does.

        ``decode_mode``: ``"cached"`` (default for gen_len > 1: slot-resident
        KV caches, continuous batching) or ``"stateless"`` (default for
        gen_len == 1: every token re-runs the padded prefix).  Both emit
        token-identical sequences.  ``batch_policy="threshold"`` packs decode
        batches by predicted retirement class.

        ``cache_layout="paged"`` (cached mode only) keeps the K/V in a
        per-replica pool of ``num_blocks`` blocks of ``block_size`` tokens
        (default: the dense footprint), reached through per-request block
        tables and allocated as generations grow; identical full prompt
        blocks are shared across requests (``prefix_sharing``).  Tokens and
        exits equal the dense layout's; admission also waits for pool
        blocks, and a pool too small for the working set raises.

        Observers (``repro_torch.obs``, ``repro_torch.control``):
        ``telemetry``, ``tracer`` and ``metrics`` subscribe to one
        instrumentation stream.  ``tracer`` (a ``SpanTracer``) builds one
        span tree per request tiling ``[arrival, retirement]`` and takes the
        wall time of every stage batch for the roofline join; on a CUDA
        device the engine then synchronizes after each batch, so the wall
        holds the batch's device work.  ``metrics`` (a ``MetricsCollector``)
        feeds a metrics registry.  With none attached every emission is
        skipped and nothing is synchronized.  Attached observers land on
        ``stats.trace`` / ``stats.metrics`` for ``ServeStats.report()``.

        ``controller`` (a ``ReconfigController``) plans a reconfiguration
        from its telemetry every ``controller.interval`` simulated seconds
        and installs it once the plan's decision time has passed.
        ``scenario`` (a ``Scenario``) perturbs a private copy of the
        topology at its event times; ``self.topo`` stays the optimizer's
        view.  A failure event re-executes the dead replica's tasks from
        their source EDs and needs the stateless single-shot plane
        (gen_len=1).
        """
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if gen_len < 1:
            raise ValueError("gen_len must be >= 1")
        if cache_layout not in ("dense", "paged"):
            raise ValueError("cache_layout must be 'dense' or 'paged'")
        paged = cache_layout == "paged"
        if decode_mode is None:
            decode_mode = "cached" if (gen_len > 1 or paged) else "stateless"
        if decode_mode not in ("cached", "stateless"):
            raise ValueError("decode_mode must be 'cached' or 'stateless'")
        if paged and decode_mode != "cached":
            raise ValueError("cache_layout='paged' requires decode_mode='cached'")
        if paged and block_size < 1:
            raise ValueError("block_size must be >= 1")
        cached = decode_mode == "cached"
        if any(int(p.shape[0]) < 1 for p in prompts):
            raise ValueError("prompts must be non-empty")
        if batch_policy not in ("fifo", "threshold"):
            raise ValueError("batch_policy must be 'fifo' or 'threshold'")
        if controller is not None and telemetry is None:
            telemetry = controller.telemetry
        if scenario is not None and any(ev.kind == "fail" for ev in scenario.events) and (
            cached or gen_len > 1
        ):
            raise ValueError(
                "failure scenarios re-execute tasks from their source ED and need the stateless "
                "single-shot plane (gen_len=1, decode_mode='stateless'); cache migration is a "
                "follow-on"
            )
        profile = self.profile
        if scenario is not None:
            # physics run on a PRIVATE copy of the serve-time topology: the
            # scenario mutates physical truth, while self.topo stays the
            # optimizer's view and learns of the drift only through
            # telemetry and reconfiguration
            topo = dataclasses.replace(
                self.topo, mu=self.topo.mu.copy(), phi_ext=self.topo.phi_ext.copy(),
                edge_rate=self.topo.edge_rate.copy(),
            )
        else:
            topo = self.topo
        programs = self.programs
        H = profile.num_stages
        eds = topo.nodes_at_stage(0)
        rate = float(arrival_rate) if arrival_rate is not None else float(topo.phi_ext.sum())
        n = len(prompts)
        if rate > 0 and np.isfinite(rate):
            if scenario is not None and scenario.modulates_arrivals:
                arrivals = _thinned_arrivals(self.rng, rate, scenario.arrival_factor,
                                             scenario.max_arrival_factor, n)
            else:
                arrivals = np.cumsum(self.rng.exponential(1.0 / rate, size=n))
        else:
            arrivals = np.sort(self.rng.uniform(0.0, duration, size=n))
        # arrival nodes follow the optimizer's traffic model: each request
        # lands on an ED with probability proportional to its phi_ext
        ed_w = topo.phi_ext[eds]
        if n and ed_w.sum() > 0:
            if scenario is not None and scenario.modulates_eds:
                # the scenario skews WHICH devices produce during its windows
                ed_idx = np.empty(n, np.int64)
                for i, t in enumerate(arrivals):
                    w = scenario.ed_weights(float(t), eds, ed_w)
                    ed_idx[i] = self.rng.choice(len(eds), p=w / w.sum())
            else:
                ed_idx = self.rng.choice(len(eds), size=n, p=ed_w / ed_w.sum())
        else:
            ed_idx = np.arange(n) % max(len(eds), 1)
        packer = None
        if batch_policy == "threshold":
            # reads self.thresholds lazily, so mid-serve reconfigurations
            # re-aim the exit predictions at once
            packer = ExitPredictor(lambda: self.thresholds, gen_len)
        # one capacity EWMA, not two: the telemetry adopts the engine's
        # monitor, so the capacity_estimates reported in ServeStats are the
        # numbers the controller planned from
        shared_monitor = telemetry is not None and hasattr(telemetry, "attach_monitor")
        if shared_monitor:
            telemetry.attach_monitor(self.straggler)
        # every observer subscribes to one instrumentation stream; None when
        # nothing is attached, so the disabled path skips every emission
        stream = build_stream(telemetry, tracer, metrics)
        wants_wall = stream is not None and stream.wants_wall

        stats = ServeStats()
        stats.trace = tracer
        stats.metrics = metrics
        # one precomputed CDF serves every routing sample; the controller's
        # installs and node failures rebuild it
        route = RoutingCdf(topo, self.p)
        # event heap: (time, seq, kind, payload)
        #   kind 0: transfer done, request joins ``node``   payload (req, node)
        #   kind 1: batch service done at ``node``          payload (node, reqs,
        #           conf [B] | None, tok [B] | None, is_decode_pass)
        #   kind 2: control plane                           payload ("scenario",
        #           event idx) | ("reconfig",) | ("install", plan)
        #   kind 3: deferred ED arrival (scenario runs only: the first hop's
        #           transfer time must see the environment AT arrival time)
        #           payload: req
        heap: list = []
        dead_nodes: set[int] = set()
        seq = itertools.count()
        wait_seq = itertools.count()  # FIFO order shared across queue kinds
        es_nodes = [int(v) for v in range(topo.num_nodes) if topo.node_stage[v] > 0]
        pending = {v: ShapeBucketBatcher(batch_size, seq=wait_seq) for v in es_nodes}
        busy_until = {v: 0.0 for v in es_nodes}
        decode_q: dict[int, deque] = {v: deque() for v in es_nodes}
        rings: dict[int, SlotRing] = {}
        slot_store: dict[int, Any] = {}
        pool_store: dict[int, Any] = {}
        state_store: dict[int, Any] = {}
        allocators: dict[int, BlockAllocator] = {}
        trash = trash_block = -1
        n_logical = 0
        max_len = max((int(p.shape[0]) for p in prompts), default=1) + gen_len
        if cached:
            n_slots = num_slots if num_slots is not None else max(2 * batch_size, 4)
            trash = n_slots  # extra store row absorbing padded-row writes
            if paged:
                n_logical = -(-max_len // block_size)
                # default pool: the dense layout's footprint, block-granular
                n_blocks = num_blocks if num_blocks is not None else n_slots * n_logical
                trash_block = n_blocks  # extra pool row absorbing trash writes
            for v in es_nodes:
                rings[v] = SlotRing(n_slots)
                h = int(topo.node_stage[v])
                if paged:
                    allocators[v] = BlockAllocator(n_blocks, block_size, prefix_sharing=prefix_sharing)
                    pool_store[v], state_store[v] = programs.init_paged_slot_caches(
                        h, n_slots + 1, n_blocks + 1, block_size, max_len
                    )
                else:
                    slot_store[v] = programs.init_slot_caches(h, n_slots + 1, max_len)
        stats.allocators = allocators
        live_reqs = 0  # admitted somewhere, not yet retired
        # paged admission reserves each row's worst-case REMAINING blocks (it
        # can still write up to prompt + gen_len - 1 positions), so a live
        # row's decode appends never starve: deadlock-free without preemption
        reserved = {v: 0 for v in es_nodes} if paged else {}

        def total_blocks(prompt_len: int) -> int:
            return -(-(prompt_len + gen_len - 1) // block_size)

        def run_prefill(node: int, reqs: list[Request], now: float) -> None:
            nonlocal live_reqs
            wall_t0 = perf_counter() if wants_wall else 0.0
            h = int(topo.node_stage[node])
            # stateless decode passes run at a FIXED padded length: causal
            # masking makes the pad rows inert and the valid rows match the
            # fixed-size cached arena
            stateless_decode = not cached and reqs[0].phase == "decode"
            pad_to = max_len if stateless_decode else None
            x_in = self._stage_input(h, reqs, batch_size, pad_to=pad_to)
            if cached:
                x, caches = programs.stage_prefill(h, x_in, max_len)
                slots = np.full((int(x.shape[0]),), trash, np.int64)
                for i, r in enumerate(reqs):
                    s = rings[node].alloc()
                    if s is None:
                        raise RuntimeError("dispatch admitted beyond ring capacity")
                    if not r.slots:  # first residency anywhere: now in flight
                        live_reqs += 1
                        stats.peak_in_flight = max(stats.peak_in_flight, live_reqs)
                    r.slots[node] = s
                    slots[i] = s
                if paged:
                    alloc = allocators[node]
                    wtab = np.full((int(x.shape[0]), n_logical), trash_block, np.int64)
                    batch_hits = batch_total = 0
                    for i, r in enumerate(reqs):
                        res = alloc.alloc(r.tokens.tolist())
                        if res is None:
                            raise RuntimeError("dispatch admitted beyond block-pool capacity")
                        r.block_seq[node] = res.handle
                        reserved[node] += total_blocks(r.prompt_len) - len(res.table)
                        for j, (blk, shared) in enumerate(zip(res.table, res.shared)):
                            # a shared block already holds this prefix and other
                            # rows read it: never rewrite it, send the write to
                            # the trash block
                            wtab[i, j] = trash_block if shared else blk
                        batch_hits += sum(res.shared)
                        batch_total += len(res.table)
                    stats.prefix_hit_blocks += batch_hits
                    stats.prefix_total_blocks += batch_total
                    programs.paged_slot_write(pool_store[node], state_store[node], caches, wtab,
                                              slots)
                    stats.block_occupancy.append(alloc.used_fraction)
                    if stream is not None:
                        stream.on_pool(now, node, alloc.used_fraction, batch_hits, batch_total)
                else:
                    programs.slot_write(slot_store[node], caches, slots)
            else:
                x = programs.run_stage(h, x_in)
            last = int(reqs[0].all_tokens().shape[0]) if stateless_decode else None
            finish_pass(node, reqs, x, now, h, is_decode_pass=False, last_valid=last,
                        wall_t0=wall_t0)

        def run_decode(node: int, reqs: list[Request], now: float) -> None:
            wall_t0 = perf_counter() if wants_wall else 0.0
            h = int(topo.node_stage[node])
            B = len(reqs)
            Bp = padded_batch_size(B, batch_size)
            slots = np.full((Bp,), trash, np.int64)
            for i, r in enumerate(reqs):
                slots[i] = r.slots[node]
            if h == 1:
                toks = np.zeros((Bp, 1), np.int32)
                for i, r in enumerate(reqs):
                    toks[i, 0] = r.generated[-1]
                x_in = programs.embed(toks)
            else:
                x_in = _cat_hidden(reqs, Bp)
            if paged:
                alloc = allocators[node]
                rtab = np.full((Bp, n_logical), trash_block, np.int32)
                for i, r in enumerate(reqs):
                    # grow the row by one position (dispatch budgeted this):
                    # crossing a block boundary takes a fresh pool block
                    res = alloc.append(r.block_seq[node])
                    if res is None:
                        raise RuntimeError("dispatch scheduled a decode row beyond pool capacity")
                    if res.new_block:
                        reserved[node] -= 1  # consumed part of the reservation
                    # the engine never forks and shares only full blocks
                    # strictly inside the prompt, while appends target
                    # pos >= prompt_len: copy-on-write cannot happen here
                    # (``programs.block_copy`` is its device half, for when
                    # preemption or fork lands)
                    if res.cow is not None:
                        raise RuntimeError("append hit a shared block")
                    tab = alloc.table(r.block_seq[node])
                    rtab[i, : len(tab)] = tab
                x = programs.paged_stage_decode(h, x_in, pool_store[node], state_store[node], rtab,
                                                slots, max_len)
                stats.block_occupancy.append(alloc.used_fraction)
                if stream is not None:
                    stream.on_pool(now, node, alloc.used_fraction)
            else:
                x = programs.stage_decode(h, x_in, slot_store[node], slots)
            finish_pass(node, reqs, x, now, h, is_decode_pass=True, wall_t0=wall_t0)

        def finish_pass(node: int, reqs: list[Request], x: torch.Tensor, now: float, h: int,
                        is_decode_pass: bool, last_valid: int | None = None,
                        wall_t0: float = 0.0) -> None:
            """Shared tail of a stage batch: heads, handoff rows, clock.

            ``last_valid`` points the heads at the last REAL position of a
            right-padded stateless decode pass.
            """
            b = self.stage_to_branch.get(h)
            x_heads = x if last_valid is None else x[:, last_valid - 1 : last_valid]
            conf = tok = None
            if h == H:
                conf, tok = programs.final_head(x_heads)
            elif b is not None:
                conf, tok = programs.exit_head(h, x_heads)
            if h < H:
                for i, r in enumerate(reqs):
                    r.hidden = x[i : i + 1]
            if conf is not None:
                conf = conf.cpu().numpy()[: len(reqs)]
                tok = tok.cpu().numpy()[: len(reqs)]
            if wants_wall and x.device.type == "cuda":
                # the hidden states stay on the card and only a head batch
                # pulls anything to the host: without this sync a batch with
                # no head would time its launches alone, and the next head
                # batch would absorb its device work.  Synced, the wall time
                # below is honest device + dispatch time, as the reference's
                # host pull of every stage output makes it.
                torch.cuda.synchronize(x.device)
            stats.num_batches += 1
            stats.num_forward_rows += int(x.shape[0])
            stats.num_real_rows += len(reqs)
            if is_decode_pass:
                # alpha[h] is the profiled cost of one TASK (= its prompt) at
                # stage h, so one cached token is charged alpha / prompt_len
                gflops = profile.alpha[h - 1] * sum(1.0 / r.prompt_len for r in reqs)
            else:
                gflops = len(reqs) * profile.alpha[h - 1]
            service = gflops / float(topo.mu[node])
            start = max(now, busy_until[node])
            done = start + service
            busy_until[node] = done
            # every batch is a capacity measurement: the EWMA follows the
            # replica's TRUE (possibly scenario-perturbed) rate.  A telemetry
            # sharing the monitor folds it in through on_batch; observe
            # directly only when none does
            if not shared_monitor:
                self.straggler.observe(node, gflops, service)
            if stream is not None:
                stream.on_batch(
                    done, node, gflops, service,
                    len(pending[node]) + len(decode_q[node]),
                    stage=h,
                    rids=tuple(r.rid for r in reqs),
                    t_dispatch=now,
                    t_start=start,
                    n_rows=int(x.shape[0]),
                    n_tokens=int(x.shape[0]) * int(x.shape[1]),
                    is_decode=is_decode_pass,
                    wall_clock_s=(perf_counter() - wall_t0) if wants_wall else 0.0,
                )
            heapq.heappush(heap, (done, next(seq), 1, (node, reqs, conf, tok, is_decode_pass)))

        def dispatch(node: int, now: float) -> None:
            """If ``node`` is free, form one batch and run it: FIFO across
            work kinds by arrival order, except that prompts blocked on slot
            space never stall waiting decode rows."""
            if now < busy_until[node]:
                return
            ph = pending[node].head_seq()
            prompt_blocks = 0
            if ph is not None and cached and rings[node].available == 0:
                ph = None  # admission blocked until a retirement frees a slot
            if ph is not None and paged:
                # admission also waits for pool blocks: each admitted row
                # reserves its sharing-blind worst-case total (prompt +
                # generation), so in-flight decode appends never starve
                _, head = pending[node].peek()
                prompt_blocks = total_blocks(head.prompt_len)
                if allocators[node].free_blocks - reserved[node] < prompt_blocks:
                    ph = None
            dq = decode_q[node]
            if paged and dq:
                # take FIFO decode rows whose next-position block fits the pool
                # now; rows that cannot extend wait without masking runnable
                # work behind them
                budget = allocators[node].free_blocks
                take: list = []
                rest: list = []
                for item in dq:
                    cost = allocators[node].append_cost(item[1].block_seq[node])
                    if len(take) < batch_size and cost <= budget:
                        take.append(item)
                        budget -= cost
                    else:
                        rest.append(item)
                if packer is not None and take:
                    # threshold-aware packing on top of the budget filter;
                    # bumped rows rejoin the queue in FIFO (seq) order
                    take, back = pack_decode_batch(take, batch_size, packer)
                    rest = sorted(back + rest)
                dh = take[0][0] if take else None
            else:
                dh = dq[0][0] if dq else None
            if ph is None and dh is None:
                return
            if dh is not None and (ph is None or dh < ph):
                if paged:
                    dq.clear()
                    dq.extend(rest)
                    reqs = [r for _, r in take]
                elif packer is not None:
                    take, rest = pack_decode_batch(list(dq), batch_size, packer)
                    dq.clear()
                    dq.extend(rest)
                    reqs = [r for _, r in take]
                else:
                    reqs = [dq.popleft()[1] for _ in range(min(batch_size, len(dq)))]
                run_decode(node, reqs, now)
                return
            max_take = rings[node].available if cached else None
            if paged:
                headroom = allocators[node].free_blocks - reserved[node]
                max_take = min(max_take, headroom // max(prompt_blocks, 1))
            if packer is not None:
                # trim the prefill take so the padded batch holds no dead rows
                cap = min(pending[node].head_len(), batch_size)
                if max_take is not None:
                    cap = min(cap, max_take)
                if cap >= 1:
                    trim = pow2_floor(cap)
                    max_take = trim if max_take is None else min(max_take, trim)
            popped = pending[node].pop_batch(max_take)
            if popped is None:
                return
            run_prefill(node, popped[1], now)

        def enqueue(req: Request, node: int, now: float) -> None:
            h = int(topo.node_stage[node])
            req.node = node
            req.stage = h
            if stream is not None:
                stream.on_enqueue(now, req.rid, node)
            if req.phase == "decode" and cached:
                decode_q[node].append((next(wait_seq), req))
            else:
                if req.phase == "decode":
                    # stateless decode pass: padded shapes are uniform, so
                    # bucket by the VALID prefix length (heads slice there)
                    key = ("dec", int(req.all_tokens().shape[0]))
                elif h == 1:
                    key = ("tok", int(req.all_tokens().shape[0]))
                else:
                    key = ("hid", tuple(req.hidden.shape[1:]))
                pending[node].push(key, req)
            dispatch(node, now)

        def finish(req: Request, done: float, c: float, h: int) -> None:
            nonlocal live_reqs
            req.exited, req.exit_stage = True, h
            req.confidence, req.output_token = c, req.generated[-1]
            req.t_done = done
            req.hidden = None
            stats.delays.append(req.delay)
            stats.exit_stage.append(h)
            stats.confidences.append(c)
            stats.tokens.append(req.generated[-1])
            stats.rids.append(req.rid)
            stats.gen_tokens.append(tuple(req.generated))
            stats.arrivals.append(req.arrival)
            stats.dones.append(done)
            if stream is not None:
                stream.on_exit(done, req.rid, h, c)
            if cached and req.slots:
                live_reqs -= 1
                freed = list(req.slots.items())
                req.slots = {}
                for v, s in freed:
                    rings[v].free(s)
                if paged:
                    for v, handle in req.block_seq.items():
                        # release the unused tail of the worst-case reservation
                        reserved[v] -= total_blocks(req.prompt_len) - len(allocators[v].table(handle))
                        allocators[v].free(handle)
                    req.block_seq = {}
                for v, _ in freed:
                    # a freed slot or block can unblock admission-waiting
                    # prompts and pool-starved decode rows
                    if pending[v].head_seq() is not None or (paged and decode_q[v]):
                        dispatch(v, done)

        def submit(req: Request, t: float) -> None:
            """First hop: sample a stage-1 replica and ship the raw task."""
            nxt, e = route.sample(self.rng, req.ed)
            req.path[1] = (nxt, int(e))
            t_cm = profile.beta[0] / float(topo.edge_rate[e])
            if stream is not None:
                stream.on_submit(t, req.rid, req.ed, req.arrival)
                stream.on_transfer(t, t + t_cm, t_cm, req.ed, nxt, req.rid, profile.beta[0])
            heapq.heappush(heap, (t + t_cm, next(seq), 0, (req, nxt)))

        def resubmit(req: Request, now: float) -> None:
            """Fail-stop re-execution: a task resident on (or in flight to) a
            failed replica restarts from scratch at its source ED."""
            stats.resubmitted += 1
            req.attempts += 1
            req.phase = "prefill"
            req.hidden = None
            req.generated.clear()
            req.path.clear()
            req.last_conf.clear()
            if stream is not None:
                stream.on_resubmit(now, req.rid)
            submit(req, now)

        def fail_node(dead: int, now: float) -> None:
            """Fail-stop of replica ``dead``, detected at once: the view and
            the environment drop its edges in lockstep (same predicate, so
            their edge arrays stay aligned), the surviving strategy is
            renormalized and the optimizer warm-starts from it; its queued
            tasks re-execute from their source EDs (tasks in service or in
            flight to it are caught at their event pops via ``dead_nodes``)."""
            nonlocal topo, route
            new_view, p_new = elastic.handle_failure(self.topo, self.p, dead)
            env_new = new_view if topo is self.topo else topo_lib.with_node_failure(topo, dead)
            self.topo = new_view
            self.state = dataclasses.replace(
                self.state,
                carry=self.state.carry._replace(p=torch.as_tensor(p_new, dtype=torch.float32)),
            )
            self._round_step = dto_ee.make_round_step(new_view, profile, self.hyper)
            topo = env_new
            route = RoutingCdf(topo, self.p)
            dead_nodes.add(dead)
            self.straggler.mu_hat[dead] = 1e-9
            if stream is not None:
                stream.on_failure(now, dead)
            while True:
                popped = pending[dead].pop_batch()
                if popped is None:
                    break
                for r in popped[1]:
                    resubmit(r, now)

        for i, (t, prompt) in enumerate(zip(arrivals, prompts)):
            req = Request(rid=i, tokens=np.asarray(prompt, np.int32), arrival=t,
                          ed=int(eds[ed_idx[i]]))
            if scenario is not None:
                # defer the first hop to arrival time so it sees the
                # environment (link rates, routing strategy) AS OF ``t``
                heapq.heappush(heap, (float(t), next(seq), 3, req))
            else:
                submit(req, t)
        if scenario is not None:
            for i, ev in enumerate(scenario.events):
                heapq.heappush(heap, (float(ev.time), next(seq), 2, ("scenario", i)))
        if controller is not None:
            heapq.heappush(heap, (float(controller.interval), next(seq), 2, ("reconfig",)))

        while heap:
            if len(stats.delays) == n:
                break  # every request measured; only control events remain
            now, _, kind, payload = heapq.heappop(heap)
            if kind == 3:  # deferred ED arrival
                submit(payload, now)
                continue
            if kind == 2:  # control plane
                tag = payload[0]
                if tag == "scenario":
                    ev = scenario.events[payload[1]]
                    if ev.kind == "fail":
                        # (cached failure was refused up front: no request
                        # can hold cache residency at the dead replica)
                        fail_node(int(ev.node), now)
                    else:
                        scenario.apply_env(ev, topo)
                elif tag == "reconfig":
                    plan = controller.plan(self, now)
                    if plan is not None:
                        # routing stays on the stale strategy until the
                        # decision time has passed: slow reconfigurations pay
                        # for their latency as in the paper
                        heapq.heappush(heap, (now + plan.decision_time, next(seq), 2,
                                              ("install", plan)))
                    # reschedule only while data-plane events remain: a
                    # starved serve must drain to the stall check below
                    # instead of ticking forever
                    if any(ev[2] != 2 for ev in heap):
                        heapq.heappush(heap, (now + controller.interval, next(seq), 2,
                                              ("reconfig",)))
                elif controller.install(self, payload[1]):
                    route = RoutingCdf(topo, self.p)
                    stats.num_reconfigs += 1
                    stats.reconfig_times.append(now)
                continue
            if kind == 0:
                req, node = payload
                if node in dead_nodes:
                    resubmit(req, now)
                    continue
                if stream is not None and req.stage == 0:
                    stream.on_arrival(req.arrival, req.ed, req.rid)
                enqueue(req, node, now)
                continue
            # kind 1: batch done — the batched exit decision is on the host
            node, reqs, conf, tok, is_decode_pass = payload
            if node in dead_nodes:
                # the replica died mid-service: its output is lost, the whole
                # batch re-executes from the source EDs
                for req in reqs:
                    resubmit(req, now)
                continue
            h = int(topo.node_stage[node])
            b = self.stage_to_branch.get(h)
            for i, req in enumerate(reqs):
                if h == H:
                    req.generated.append(int(tok[i]))
                    if len(req.generated) >= gen_len:
                        finish(req, now, float(conf[i]), h)
                        continue
                    # loop back for the next token: one-token payload to the
                    # request's pinned stage-1 replica
                    req.phase = "decode"
                    node1, e1 = req.path[1]
                    t_cm = profile.beta[0] / float(topo.edge_rate[e1]) / req.prompt_len
                    if stream is not None:
                        stream.on_loopback(now, now + t_cm, node, node1, req.rid,
                                           profile.beta[0] / req.prompt_len)
                    heapq.heappush(heap, (now + t_cm, next(seq), 0, (req, node1)))
                    continue
                if b is not None:
                    # confidence history feeds the threshold-aware packer
                    req.last_conf[b] = float(conf[i])
                    if float(conf[i]) >= self.thresholds[b]:
                        # confident early exit: emit and retire
                        req.generated.append(int(tok[i]))
                        finish(req, now, float(conf[i]), h)
                        continue
                nh = h + 1
                if nh in req.path:
                    nxt, e = req.path[nh]
                else:
                    nxt, e = route.sample(self.rng, node)
                    req.path[nh] = (nxt, int(e))
                t_cm = profile.beta[h] / float(topo.edge_rate[e])
                if is_decode_pass:
                    t_cm /= req.prompt_len
                if stream is not None:
                    stream.on_transfer(now, now + t_cm, t_cm, node, nxt, req.rid,
                                       profile.beta[h] / (req.prompt_len if is_decode_pass else 1))
                heapq.heappush(heap, (now + t_cm, next(seq), 0, (req, nxt)))
            dispatch(node, now)

        stats.capacity_estimates = {int(v): float(self.straggler.mu_hat[v]) for v in es_nodes}
        if len(stats.delays) != n:
            # a stall is starvation no future event can clear: fail loudly
            hint = (
                "the KV block pool cannot cover the in-flight working set: raise num_blocks, "
                "shrink num_slots, or use cache_layout='dense'"
                if paged else "requests were left queued with no runnable work"
            )
            raise RuntimeError(
                f"serve stalled with {n - len(stats.delays)} of {n} requests unfinished; {hint}"
            )
        return stats


def _cat_hidden(reqs: list[Request], padded: int) -> torch.Tensor:
    """The requests' [1, S, d] hidden rows stacked and zero-padded to ``padded`` rows."""
    hs = [r.hidden for r in reqs]
    if padded > len(reqs):
        hs.append(hs[0].new_zeros((padded - len(reqs),) + tuple(hs[0].shape[1:])))
    return torch.cat(hs, dim=0) if len(hs) > 1 else hs[0]
