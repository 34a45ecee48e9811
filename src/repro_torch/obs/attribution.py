"""Delay attribution: measured span sums vs the paper's delay model.

The counterpart of ``repro.obs.attribution``; the model side runs on the
port's ``core.queueing`` (float32 torch on the CPU).

Two layers:

:func:`decompose`
    Pure bookkeeping over a :class:`~repro_torch.obs.trace.SpanTracer` — for every
    closed request, sum its span tree by component (admission / transfer /
    queue / batch_wait / compute), check the sum reconciles with the
    engine-reported delay (the tiling invariant), and aggregate per-stage
    and per-node means.

:func:`attribution_report`
    Joins the measured decomposition with the DTO-EE model terms the
    optimizer actually minimizes (paper Eqs. 4/6/8): per node, the M/D/1-PS
    sojourn ``alpha/(mu - lam)`` at the steady-state flows vs the measured
    per-visit sojourn (queue + batch_wait + compute at that node); per
    request, the aggregate queue/compute/comms split vs the model's
    ``sum_j lam_j/(mu_j - lam_j)/Phi + sum_e phi_e * T^cm_e / Phi``.  The
    per-node relative error says when the model DTO-EE optimizes no longer
    describes the engine.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.queueing import (
    alpha_per_node,
    steady_state_flows,
    t32,
    transmission_delay_per_edge,
)
from repro_torch.obs.trace import SPAN_KINDS

__all__ = ["decompose", "attribution_report"]

#: span kinds spent *at a serving node* — measured counterpart of the
#: model's M/D/1-PS sojourn
NODE_KINDS = ("queue", "batch_wait", "compute")


def decompose(tracer, stats=None, tol: float = 1e-6) -> dict:
    """Measured delay decomposition of one serve.

    Returns a JSON-able dict with per-request component sums, the
    reconciliation residual |sum(components) - reported delay| (must vanish:
    the span tiling is exact), and per-stage / per-node component means.
    """
    reported: dict[int, float] = {}
    if stats is not None:  # ServeStats keeps parallel rid/delay lists
        for rid, delay in zip(
            getattr(stats, "rids", ()), getattr(stats, "delays", ())
        ):
            reported[int(rid)] = float(delay)

    per_request: list[dict] = []
    totals = {k: 0.0 for k in SPAN_KINDS}
    # node -> [sum queue, sum batch_wait, sum compute, visits]
    node_acc: dict[int, list[float]] = {}
    stage_acc: dict[int, dict[str, float]] = {}
    max_residual = 0.0
    n_lost = 0

    for rid, spans in tracer.spans.items():
        if not tracer.closed(rid):
            continue
        comp = {k: 0.0 for k in SPAN_KINDS}
        lost = 0.0
        for s in spans:
            if s.attrs and s.attrs.get("lost"):
                lost += s.duration
                continue
            comp[s.kind] += s.duration
            if s.kind in NODE_KINDS and s.node >= 0:
                acc = node_acc.setdefault(s.node, [0.0, 0.0, 0.0, 0])
                acc[NODE_KINDS.index(s.kind)] += s.duration
                if s.kind == "compute":
                    acc[3] += 1
            if s.kind in NODE_KINDS and s.stage >= 0:
                sacc = stage_acc.setdefault(
                    s.stage, {k: 0.0 for k in NODE_KINDS} | {"visits": 0}
                )
                sacc[s.kind] += s.duration
                if s.kind == "compute":
                    sacc["visits"] += 1
        if lost:
            n_lost += 1
        # normalize to Python floats: engine timestamps can be np.float64
        # (arrival times come off np.cumsum) and the reports must JSON-dump
        comp = {k: float(v) for k, v in comp.items()}
        lost = float(lost)
        total = sum(comp.values()) + lost
        span_delay = float(spans[-1].t1 - spans[0].t0)
        entry = {"rid": rid, **comp, "lost": lost, "total": total}
        if rid in reported:
            entry["reported_delay"] = reported[rid]
            entry["residual"] = abs(total - reported[rid])
            max_residual = max(max_residual, entry["residual"])
        else:
            entry["residual"] = abs(total - span_delay)
            max_residual = max(max_residual, entry["residual"])
        per_request.append(entry)
        for k in SPAN_KINDS:
            totals[k] += comp[k]

    n = len(per_request)
    per_node = {
        int(node): {
            "queue_s": float(acc[0]),
            "batch_wait_s": float(acc[1]),
            "compute_s": float(acc[2]),
            "visits": acc[3],
            "sojourn_per_visit_s": float(sum(acc[:3]) / acc[3]) if acc[3] else 0.0,
        }
        for node, acc in sorted(node_acc.items())
    }
    per_stage = {
        int(stage): {
            "queue_mean_s": float(acc["queue"] / acc["visits"]) if acc["visits"] else 0.0,
            "batch_wait_mean_s": float(acc["batch_wait"] / acc["visits"]) if acc["visits"] else 0.0,
            "compute_mean_s": float(acc["compute"] / acc["visits"]) if acc["visits"] else 0.0,
            "visits": acc["visits"],
        }
        for stage, acc in sorted(stage_acc.items())
    }
    return {
        "num_requests": n,
        "num_with_lost_time": n_lost,
        "max_residual_s": float(max_residual),
        "reconciles": bool(max_residual <= tol),
        "mean_components_s": {
            k: float(totals[k] / n) if n else 0.0 for k in SPAN_KINDS
        },
        "per_stage": per_stage,
        "per_node": per_node,
        "per_request": per_request,
    }


def attribution_report(tracer, p, topo, profile, I_node, stats=None) -> dict:
    """Measured vs DTO-EE-model delay attribution.

    ``p, topo, profile, I_node`` are exactly the optimizer's inputs (offload
    probabilities, topology, model profile, per-node remaining ratios), so
    the model side is the same expression DTO-EE minimized.
    """
    meas = decompose(tracer, stats)
    phi, lam = steady_state_flows(t32(p), topo, profile, t32(I_node))
    phi = phi.numpy().astype(np.float64)
    lam = lam.numpy().astype(np.float64)
    alpha_n = alpha_per_node(topo, profile)
    mu = np.where(np.isinf(topo.mu), 1e30, np.asarray(topo.mu, np.float64))
    gap = mu - lam
    es = topo.node_stage > 0

    # model per-visit terms on each ES (Eq. 6 split into service + wait)
    sojourn = np.where(es & (gap > 0), alpha_n / np.where(gap > 0, gap, 1.0), 0.0)
    service = np.where(es, alpha_n / mu, 0.0)
    wait = sojourn - service

    per_node = {}
    for j in np.flatnonzero(es):
        j = int(j)
        m = meas["per_node"].get(j)
        model_sojourn = float(sojourn[j])
        entry = {
            "model_sojourn_s": model_sojourn,
            "model_compute_s": float(service[j]),
            "model_queue_s": float(wait[j]),
            "model_lam_gflops": float(lam[j]),
            "measured_sojourn_s": m["sojourn_per_visit_s"] if m else 0.0,
            "visits": m["visits"] if m else 0,
        }
        if m and model_sojourn > 0:
            entry["rel_error"] = (
                m["sojourn_per_visit_s"] - model_sojourn
            ) / model_sojourn
        per_node[j] = entry

    # aggregate per-request split (model: Eq. 8 decomposed)
    total_phi = float(np.asarray(topo.phi_ext, np.float64).sum())
    t_cm = np.asarray(transmission_delay_per_edge(topo, profile), np.float64)
    I_np = np.asarray(I_node, np.float64)
    phi_edge = np.asarray(p, np.float64) * phi[topo.edge_src] * I_np[topo.edge_src]
    model_comms = float((phi_edge * t_cm).sum() / total_phi) if total_phi else 0.0
    model_node = float((lam[es] / np.where(gap[es] > 0, gap[es], np.inf)).sum()
                       / total_phi) if total_phi else 0.0
    model_compute = float((phi[es] * alpha_n[es] / mu[es]).sum() / total_phi) \
        if total_phi else 0.0

    mc = meas["mean_components_s"]
    measured_node = mc["queue"] + mc["batch_wait"] + mc["compute"]
    report = {
        "measured": {
            "queue_s": mc["queue"] + mc["batch_wait"],
            "compute_s": mc["compute"],
            "comms_s": mc["transfer"],
            "admission_s": mc["admission"],
            "total_s": sum(mc.values()),
        },
        "model": {
            "queue_s": model_node - model_compute,
            "compute_s": model_compute,
            "comms_s": model_comms,
            "total_s": model_node + model_comms,
        },
        "rel_error": {
            "node_sojourn": (measured_node - model_node) / model_node
            if model_node else float("nan"),
            "comms": (mc["transfer"] - model_comms) / model_comms
            if model_comms else float("nan"),
        },
        "per_node": per_node,
        "reconciles": meas["reconciles"],
        "max_residual_s": meas["max_residual_s"],
        "num_requests": meas["num_requests"],
    }
    return report
