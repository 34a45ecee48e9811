"""Discrete-event simulator of the collaborative-inference edge network.

The counterpart of ``repro.core.simulator``, numpy on the host as there:
the same event loop and the same draws from the same seed, so the same
inputs give the reference's result exactly.

This is the measurement side of the paper's evaluation (§4): tasks arrive at
EDs as Poisson processes, are routed hop-by-hop per the offloading strategy
P, receive deterministic service (alpha_h GFLOPs) at each ES under
**processor sharing** (the M/D/1-PS model of Eq. 6), and may exit early when
their branch confidence clears the threshold.  Response delay is measured
per task from ED arrival to exit; accuracy comes from the same recorded
validation outputs the accuracy-ratio table uses, so the analytic optimizer
and the simulator agree on what a threshold does.

Implementation: a heap event loop with versioned completion events (PS
queues reschedule their earliest completion whenever membership changes).
Python-level, but task counts are O(1e4) per slot — milliseconds to run.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools

import numpy as np

from repro_torch.core.thresholds import ExitProfile
from repro_torch.core.types import ModelProfile, Topology


@dataclasses.dataclass
class SimResult:
    mean_delay: float
    p95_delay: float
    accuracy: float
    completed: int
    generated: int
    exit_fraction: np.ndarray  # per branch (early branches..., final)
    mean_delay_per_stage: np.ndarray  # diagnostic: time spent per stage index


class _PSQueue:
    """Single-server processor-sharing queue with deterministic job sizes.

    Membership lives in flat numpy arrays (``_ids`` / ``_rem``, swap-remove
    on departure) so ``advance`` — the simulator's hot loop, called on every
    event touching the queue — is one vectorized subtraction instead of a
    per-job Python dict walk, and finished jobs are harvested in one
    ``pop_done`` mask rather than a per-item scan.
    """

    __slots__ = ("mu", "t", "version", "_ids", "_rem", "_slot", "_n", "_min_slot")

    def __init__(self, mu: float, capacity: int = 64):
        self.mu = mu
        self.t = 0.0
        self.version = 0
        self._ids = np.empty(capacity, np.int64)
        self._rem = np.empty(capacity, np.float64)
        self._slot: dict[int, int] = {}  # job id -> slot in the arrays
        self._n = 0
        # cached argmin slot (-1 = unknown).  PS decrements are uniform, so
        # the ordering of remaining works only changes on add/remove — adds
        # update the cache in O(1) and next_completion avoids an O(n) scan
        # per event.
        self._min_slot = -1

    def __len__(self) -> int:
        return self._n

    def advance(self, now: float) -> None:
        if self._n:
            self._rem[: self._n] -= self.mu / self._n * (now - self.t)
        self.t = now

    def add(self, now: float, job: int, work: float) -> None:
        self.advance(now)
        if self._n == self._ids.shape[0]:
            self._ids = np.concatenate([self._ids, np.empty_like(self._ids)])
            self._rem = np.concatenate([self._rem, np.empty_like(self._rem)])
        slot = self._n
        self._ids[slot] = job
        self._rem[slot] = work
        self._slot[job] = slot
        self._n += 1
        if self._min_slot >= 0 and work < self._rem[self._min_slot]:
            self._min_slot = slot
        self.version += 1

    def _drop_slot(self, slot: int) -> None:
        last = self._n - 1
        if self._min_slot == slot:
            self._min_slot = -1
        elif self._min_slot == last:
            self._min_slot = slot
        if slot != last:
            self._ids[slot] = self._ids[last]
            self._rem[slot] = self._rem[last]
            self._slot[int(self._ids[slot])] = slot
        self._n = last

    def remove(self, now: float, job: int) -> None:
        self.advance(now)
        slot = self._slot.pop(job, None)
        if slot is None:
            return
        self._drop_slot(slot)
        self.version += 1

    def pop_done(self, eps: float = 1e-12) -> list[int]:
        """Remove and return every job with no remaining work (one mask scan,
        then swap-remove per finished job — descending so slots stay valid)."""
        n = self._n
        if not n:
            return []
        idx = np.nonzero(self._rem[:n] <= eps)[0]
        if not idx.size:
            return []
        done = []
        for slot in idx[::-1].tolist():
            j = int(self._ids[slot])
            done.append(j)
            del self._slot[j]
            self._drop_slot(slot)
        self.version += 1
        return done

    def pop_overdue(self, now: float) -> list[int]:
        """Force-complete the earliest job if its completion time is <= now.

        Floating-point residue can leave a finished job's remaining work a
        hair above the ``pop_done`` eps while its completion event has
        already fired; without this the candidate event re-schedules itself
        at a frozen clock and the event loop livelocks.
        """
        nxt = self.next_completion()
        if nxt is None or nxt[0] > now:
            return []
        job = nxt[1]
        self._drop_slot(self._slot.pop(job))
        self.version += 1
        return [job]

    def next_completion(self) -> tuple[float, int] | None:
        if not self._n:
            return None
        if self._min_slot < 0:
            self._min_slot = int(np.argmin(self._rem[: self._n]))
        i = self._min_slot
        return (
            self.t + max(float(self._rem[i]), 0.0) * self._n / self.mu,
            int(self._ids[i]),
        )


@dataclasses.dataclass
class _Task:
    tid: int
    arrival: float
    record: int  # row in the exit profile's validation record
    stage: int = 0  # stage of the node it currently sits on / travels to
    node: int = -1
    t_enter_stage: float = 0.0


class RoutingCdf:
    """Per-strategy cache of the routing CDF over every node's out-edges.

    Successor sampling is one inverse-CDF draw (``searchsorted`` into the
    node's precomputed cumsum slice) instead of an ``rng.choice(p=...)``
    call — the simulator samples once per task-hop, so this is hot.
    """

    def __init__(self, topo: Topology, p: np.ndarray):
        self.topo = topo
        self.cdf = np.cumsum(np.asarray(p, np.float64))
        # per-node total mass: cdf[hi-1] - (cdf[lo-1] if lo else 0)
        off = topo.edge_offsets

        def _at(i: int) -> float:
            return float(self.cdf[i - 1]) if i > 0 else 0.0

        self.lo_mass = np.array([_at(int(o)) for o in off[:-1]])
        self.hi_mass = np.array([_at(int(o)) for o in off[1:]])

    def sample(self, rng: np.random.Generator, node: int) -> tuple[int, int]:
        topo = self.topo
        lo, hi = int(topo.edge_offsets[node]), int(topo.edge_offsets[node + 1])
        m_lo, m_hi = self.lo_mass[node], self.hi_mass[node]
        if m_hi - m_lo <= 0:
            e = int(rng.integers(lo, hi))
        else:
            r = m_lo + rng.random() * (m_hi - m_lo)
            e = min(int(np.searchsorted(self.cdf[lo:hi], r, side="right")) + lo, hi - 1)
        return int(topo.edge_dst[e]), e


def simulate_slot(
    topo: Topology,
    profile: ModelProfile,
    exit_profile: ExitProfile,
    p: np.ndarray,
    thresholds: np.ndarray,
    duration: float = 5.0,
    seed: int = 0,
    warmup: float = 0.5,
    strategy_switch: tuple[float, np.ndarray] | None = None,
    coalesce: bool = True,
    tracer=None,
) -> SimResult:
    """Simulate one task-offloading phase of ``duration`` seconds.

    ``strategy_switch = (t_ready, p_old)``: before ``t_ready`` (the
    algorithm's decision time) routing uses ``p_old`` — this is how the
    dynamic-environment experiment charges NGTO/GA for their slow decisions.

    Tasks still in flight at the slot end are dropped from the delay average
    (the paper measures completed samples only).

    ``coalesce`` harvests every event sharing the popped timestamp in one
    gulp (processing order — heap order at equal times — is unchanged, so
    results are identical); ``False`` keeps the one-pop-per-iteration loop
    for A/B measurement.

    ``tracer`` (a :class:`repro_torch.obs.trace.SpanTracer`) receives one span
    tree per task with SIMULATED timestamps injected at each event — the
    simulator has no clock of its own beyond the heap, so span times are the
    exact event floats.  PS service is one ``compute`` span per hop
    (``ps=True``: processor sharing interleaves, so the sojourn is not
    separable into wait + service); transfers and retirements mirror the
    serving engine's vocabulary.  ``None`` skips every emission.
    """
    rng = np.random.default_rng(seed)
    p = np.asarray(p, np.float64)
    H = profile.num_stages
    thresholds = np.asarray(thresholds, np.float64)
    n_records = exit_profile.conf.shape[0]
    # stage (1-indexed) -> early-branch index
    stage_to_branch = {s: b for b, s in enumerate(exit_profile.branch_stage[:-1])}

    queues = {
        int(v): _PSQueue(float(topo.mu[v]))
        for v in range(topo.num_nodes)
        if topo.node_stage[v] > 0
    }

    # --- seed arrival events -----------------------------------------------
    # heap entries: (time, seq, kind, payload)
    #   kind 0: task arrives at an ED            payload: ed
    #   kind 1: transfer completes, join queue   payload: (task, node)
    #   kind 2: PS completion candidate          payload: (node, version)
    heap: list = []
    seq = itertools.count()
    for ed in topo.nodes_at_stage(0):
        rate = float(topo.phi_ext[ed])
        if rate <= 0:
            continue
        t = rng.exponential(1.0 / rate)
        while t < duration:
            heapq.heappush(heap, (t, next(seq), 0, int(ed)))
            t += rng.exponential(1.0 / rate)

    tasks: dict[int, _Task] = {}
    tid_counter = itertools.count()
    delays: list[float] = []
    correct_flags: list[bool] = []
    exit_counts = np.zeros(len(exit_profile.branch_stage), np.int64)
    stage_time = np.zeros(H + 1, np.float64)
    generated = 0

    route_cdf = RoutingCdf(topo, p)
    route_cdf_old = (
        RoutingCdf(topo, strategy_switch[1]) if strategy_switch is not None else None
    )

    def routing(now: float) -> RoutingCdf:
        if strategy_switch is not None and now < strategy_switch[0]:
            return route_cdf_old
        return route_cdf

    def schedule_completion(now: float, node: int) -> None:
        q = queues[node]
        nxt = q.next_completion()
        if nxt is not None:
            heapq.heappush(heap, (nxt[0], next(seq), 2, (node, q.version)))

    def depart(now: float, task: _Task, node: int) -> None:
        """Service done at ``node`` (stage h): exit early or offload onward."""
        h = int(topo.node_stage[node])
        stage_time[h] += now - task.t_enter_stage
        b = stage_to_branch.get(h)
        exits_here = False
        if b is not None:
            exits_here = exit_profile.conf[task.record, b] >= thresholds[b]
        if tracer is not None:
            tracer.add_span(
                task.tid, "compute", task.t_enter_stage, now, node=node,
                stage=h, ps=True,
            )
        if h == H or exits_here:
            delays.append(now - task.arrival)
            branch = b if (exits_here and h < H) else len(exit_counts) - 1
            exit_counts[branch] += 1
            correct_flags.append(bool(exit_profile.correct[task.record, branch]))
            tasks.pop(task.tid, None)
            if tracer is not None:
                tracer.on_exit(
                    now, task.tid, h,
                    float(exit_profile.conf[task.record, branch]),
                )
            return
        send(now, task, node)

    def send(now: float, task: _Task, node: int) -> None:
        """Offload from ``node`` to a sampled successor (transmission hop)."""
        nxt, e = routing(now).sample(rng, node)
        h_next = int(topo.node_stage[nxt])
        beta = profile.beta[h_next - 1]
        t_cm = beta / float(topo.edge_rate[e])
        task.stage = h_next
        task.node = nxt
        if tracer is not None:
            tracer.on_transfer(now, now + t_cm, t_cm, node, nxt, task.tid, beta)
        heapq.heappush(heap, (now + t_cm, next(seq), 1, (task.tid, nxt)))

    # Arrivals stop at ``duration``; queues then drain so every generated
    # task is measured (the paper averages completed samples).  The horizon
    # only guards against a pathologically unstable configuration.
    horizon = duration * 20.0
    batch: list = []
    while heap:
        now, _, kind, payload = heapq.heappop(heap)
        if now > horizon:
            break
        batch.clear()
        batch.append((kind, payload))
        if coalesce:
            # Same-timestamp harvest: drain every event already queued at
            # ``now`` in one pop burst.  Heap order at equal times is seq
            # order, and a handler pushing a new event at ``now`` gets a
            # larger seq than anything queued — so the processing order is
            # exactly the one-pop-per-iteration loop's, with one outer-loop
            # pass (horizon check, tuple unpack) per timestamp instead of
            # per event.
            while heap and heap[0][0] == now:
                _, _, k, pl = heapq.heappop(heap)
                batch.append((k, pl))
        for kind, payload in batch:
            if kind == 0:
                ed = payload
                task = _Task(
                    tid=next(tid_counter),
                    arrival=now,
                    record=int(rng.integers(0, n_records)),
                )
                generated += 1
                tasks[task.tid] = task
                if tracer is not None:
                    # sim-time clock injection: the tracer's SimClock follows
                    # the heap's event floats, not wall time
                    tracer.on_submit(now, task.tid, int(ed), now)
                send(now, task, ed)
            elif kind == 1:
                tid, node = payload
                task = tasks.get(tid)
                if task is None:
                    continue
                task.t_enter_stage = now
                q = queues[node]
                work = profile.alpha[int(topo.node_stage[node]) - 1]
                q.add(now, tid, work)
                schedule_completion(now, node)
            else:  # kind == 2: completion candidate
                node, version = payload
                q = queues[node]
                if version != q.version:
                    continue  # stale
                q.advance(now)
                done = q.pop_done()
                if not done:
                    done = q.pop_overdue(now)
                schedule_completion(now, node)
                for j in done:
                    task = tasks.get(j)
                    if task is not None:
                        depart(now, task, node)

    delays_a = np.asarray(delays)
    keep = delays_a if warmup <= 0 else delays_a  # all completions counted
    mean_delay = float(keep.mean()) if keep.size else float("inf")
    p95 = float(np.percentile(keep, 95)) if keep.size else float("inf")
    acc = float(np.mean(correct_flags)) if correct_flags else 0.0
    total_exits = max(exit_counts.sum(), 1)
    return SimResult(
        mean_delay=mean_delay,
        p95_delay=p95,
        accuracy=acc,
        completed=int(keep.size),
        generated=generated,
        exit_fraction=exit_counts / total_exits,
        mean_delay_per_stage=stage_time / max(len(delays), 1),
    )
