"""The port's host spans (``repro_torch.obs.HostSpans``) inside a serve.

Off, the serve reads no clock for them and serves what it serves with them
on.  On, over a cached-decode serve (dense and paged) and a stateless
single-shot serve of a tiny stablelm: one ``engine.batch`` a stage batch
carrying ``on_batch``'s rows, every span inside its parent, the slot gather /
layers / scatter on decode batches alone, a head pull on head stages alone,
and self times that tile the serve's wall.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.profiles import profile_from_arch
from repro_torch.core.thresholds import synthetic_validation
from repro_torch.core.topology import NetworkSpec, build_edge_network
from repro_torch.core.types import DtoHyperParams
from repro_torch.models import model as model_lib
from repro_torch.obs import HOST_SPANS, HostSpans
from repro_torch.obs import trace as trace_mod
from repro_torch.serving import CollaborativeEngine
from repro_torch.serving import engine as engine_mod

torch.set_num_threads(1)

CFG = configs.get_config("stablelm-1.6b").reduced(vocab_size=128)
MODES = {
    "cached": dict(gen_len=3, batch_size=4, decode_mode="cached"),
    "stateless": dict(gen_len=1, batch_size=4, decode_mode="stateless"),
    "paged": dict(gen_len=3, batch_size=4, cache_layout="paged", block_size=4),
}
PARENTS = {
    "engine.configuration": None,
    "engine.serve": None,
    "engine.batch": "engine.serve",
    "engine.input": "engine.batch",
    "engine.head_pull": "engine.batch",
    "stage.embed": "engine.input",
    "stage.forward": "engine.batch",
    "stage.prefill": "engine.batch",
    "stage.decode": "engine.batch",
    "stage.slot_write": "engine.batch",
    "stage.gather": "stage.decode",
    "stage.layers": "stage.decode",
    "stage.scatter": "stage.decode",
    "stage.heads": "engine.batch",
}
DECODE_PARTS = ("stage.gather", "stage.layers", "stage.scatter")


def _engine():
    gen = torch.Generator().manual_seed(0)
    params = model_lib.init_params(CFG, gen, "cpu")
    profile = profile_from_arch(CFG)
    topo = build_edge_network(seed=0, profile=profile,
                              spec=NetworkSpec(num_eds=4, es_per_stage=(2, 2)))
    exits = synthetic_validation(seed=1, profile=profile)
    return CollaborativeEngine(params, CFG, topo, profile, exits, DtoHyperParams(rounds=5), seed=0,
                               device="cpu")


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, CFG.vocab_size, size=int(n)).astype(np.int32)
            for n in rng.integers(4, 13, size=10)]


class _Batches:
    """An observer keeping each ``on_batch``'s detail."""

    def __init__(self):
        self.batches = []

    def on_batch(self, t, node, gflops, wall, queue_depth, **detail):
        self.batches.append(dict(detail, node=node))


def _serve(mode, host_spans):
    engine = _engine()
    engine.host_spans = host_spans
    engine.configuration_phase()
    obs = _Batches()
    stats = engine.serve(_prompts(), arrival_rate=50.0, metrics=obs, **MODES[mode])
    return stats, obs


@pytest.fixture(scope="module", params=list(MODES))
def served(request):
    hs = HostSpans()
    stats, obs = _serve(request.param, hs)
    return request.param, hs, stats, obs


def _batch_of(spans, i):
    """The ``engine.batch`` span that span ``i`` lies in."""
    while spans[i].name != "engine.batch":
        i = spans[i].parent
    return spans[i]


def test_host_spans_off_read_no_clock(monkeypatch):
    calls = []

    def counted():
        calls.append(1)
        return 0

    monkeypatch.setattr(trace_mod, "perf_counter_ns", counted)
    monkeypatch.setattr(engine_mod, "perf_counter_ns", counted)
    _serve("cached", None)
    assert calls == []
    _serve("cached", HostSpans())
    assert calls  # the counter sees the reads the spans make


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_with_host_spans_is_bitwise_the_serve_without(mode):
    off, obs_off = _serve(mode, None)
    on, obs_on = _serve(mode, HostSpans())
    assert on.sequences_by_rid() == off.sequences_by_rid()
    assert on.confidences == off.confidences
    assert on.delays == off.delays
    assert [b["rids"] for b in obs_on.batches] == [b["rids"] for b in obs_off.batches]
    assert all(b["host_span"] == -1 for b in obs_off.batches)


def test_one_batch_span_a_stage_batch_with_on_batch_rows(served):
    _, hs, stats, obs = served
    spans = hs.spans
    batch_spans = [s for s in spans if s.name == "engine.batch"]
    assert len(batch_spans) == len(obs.batches) == stats.num_batches
    for b in obs.batches:
        s = spans[b["host_span"]]
        assert s.name == "engine.batch"
        assert dict(zip(HostSpans.BATCH_ATTRS, s.attrs)) == dict(
            stage=b["stage"], node=b["node"], live_rows=len(b["rids"]),
            padded_rows=b["n_rows"], decode=int(b["is_decode"]))


def test_every_span_nests_in_its_parent(served):
    _, hs, _, _ = served
    spans = hs.spans
    names = {s.name for s in spans}
    assert names <= set(HOST_SPANS)
    assert {"engine.configuration", "engine.serve", "engine.batch", "engine.input",
            "engine.head_pull", "stage.embed", "stage.heads"} <= names
    for s in spans:
        assert 0 < s.t0 <= s.t1
        want = PARENTS[s.name]
        if want is None:
            assert s.parent == -1
            continue
        p = spans[s.parent]
        assert p.name == want, (s.name, p.name)
        assert p.t0 <= s.t0 and s.t1 <= p.t1


def test_decode_parts_only_in_decode_batches(served):
    mode, hs, _, obs = served
    spans = hs.spans
    decode_batches = {b["host_span"] for b in obs.batches if b["is_decode"]}
    seen = {}
    for i, s in enumerate(spans):
        if s.name in DECODE_PARTS:
            batch = _batch_of(spans, i)
            assert batch.attrs[4] == 1
            seen.setdefault(spans.index(batch), []).append(s.name)
    assert set(seen) == decode_batches
    assert all(parts == list(DECODE_PARTS) for parts in seen.values())
    assert bool(decode_batches) == (mode != "stateless")


def test_head_pull_only_on_head_stages(served):
    _, hs, _, obs = served
    spans = hs.spans
    heads = set(CFG.exit_stages) | {CFG.num_stages}
    pulls = [spans[s.parent] for s in spans if s.name == "engine.head_pull"]
    assert all(p.attrs[0] in heads for p in pulls)
    assert len(pulls) == sum(b["stage"] in heads for b in obs.batches)
    assert len(pulls) == sum(s.name == "stage.heads" for s in spans)


def test_self_times_tile_the_serve(served):
    _, hs, _, _ = served
    spans = hs.spans
    (serve,) = [s for s in spans if s.name == "engine.serve"]
    inside = hs.self_ns(serve.t0, serve.t1)
    inside["engine.configuration"] = 0  # before the serve, clipped away
    assert abs(sum(inside.values()) - (serve.t1 - serve.t0)) <= 0.01 * (serve.t1 - serve.t0)
    assert all(v >= 0 for v in inside.values())
    # siblings never overlap
    kids: dict[int, list] = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    for group in kids.values():
        for a, b in zip(group, group[1:]):
            assert a.t1 <= b.t0


def test_an_exception_closes_the_spans_it_leaves_open():
    class Cut(Exception):
        pass

    class CutAtThird(_Batches):
        def on_batch(self, *a, **k):
            super().on_batch(*a, **k)
            if len(self.batches) == 3:
                raise Cut

    hs = HostSpans()
    engine = _engine()
    engine.host_spans = hs
    with pytest.raises(Cut):
        engine.serve(_prompts(), arrival_rate=50.0, metrics=CutAtThird(), **MODES["cached"])
    spans = hs.spans
    assert spans[-1].t1 > 0 and all(s.t1 >= s.t0 > 0 for s in spans)
    engine.configuration_phase()
    assert hs.spans[-1].name == "engine.configuration" and hs.spans[-1].parent == -1
