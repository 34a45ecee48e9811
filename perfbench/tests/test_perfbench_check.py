"""The check that decides ``correct``, driven on the CPU at a tiny size: the
whole run but the look for a chip, the port's plain kernel versions in
place of the CUDA ones.  The program agrees with the reference; the fp8
control and each fault the cells can have, planted underneath the timed
path, come out not correct."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from perfbench_tiny import TINY_LIMITS, run_tiny, tiny_cell

from perfbench.harness.check import _readings
from repro_torch.kernels import ref
from repro_torch.serving import steps

CELLS = ("stablelm-1.6b.generate", "glm4-9b.single_shot")


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_reference_and_control_does_not(name):
    r = run_tiny(tiny_cell(name), control=True)
    assert r["correct"], r["checks"]
    assert r["checks"]["missing"]["value"] == 0
    # the fp8 control, put in the program's place, fails the cell's limits
    # by the run's own verdict
    assert not r["control"]["correct"], r["control"]


def _unchanged(real):
    """A step that returns its state unchanged: the stage's input back, the
    caches untouched."""
    def step(params, x, *a, **k):
        return x
    return step


def _half(real):
    """Half of the batch left out: the other half's rows replaced by the
    mean of the computed ones."""
    def step(*a, **k):
        out = real(*a, **k)
        n = max(out.shape[0] // 2, 1)
        if out.shape[0] > 1:
            out = out.clone()
            out[n:] = out[:n].mean(dim=0, keepdim=True)
        return out
    return step


def _altered_token(real):
    """A token altered where it is produced: the head's argmax plus one."""
    def head(h, w):
        conf, tok = real(h, w)
        return conf, (tok + 1) % w.shape[1]
    return head


FAULTS = {
    # (cell, module, attribute, fault, mix overrides)
    "generate-unchanged": ("stablelm-1.6b.generate", steps, "stage_decode", _unchanged, {}),
    "generate-half": ("stablelm-1.6b.generate", steps, "stage_decode", _half, {}),
    "generate-token": ("stablelm-1.6b.generate", ref, "exit_confidence_ref", _altered_token, {}),
    "single_shot-unchanged": ("glm4-9b.single_shot", steps, "stage_forward", _unchanged, {}),
    # equal lengths, so that prefill batches hold several rows
    "single_shot-half": ("glm4-9b.single_shot", steps, "stage_forward", _half,
                         {"prompt": {"median": 12, "sigma": 0.6, "min": 12, "max": 12}}),
    "single_shot-token": ("glm4-9b.single_shot", ref, "exit_confidence_ref", _altered_token, {}),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(fault, monkeypatch):
    name, module, attr, make, mix = FAULTS[fault]
    cell = tiny_cell(name, **mix)
    if mix:  # the cells' own tiny mixes are shown correct above
        clean = run_tiny(cell)
        assert clean["correct"], clean["checks"]
    monkeypatch.setattr(module, attr, make(getattr(module, attr)))
    r = run_tiny(cell)
    assert not r["correct"], r["checks"]


def test_reference_matches_port_heads():
    """The reference's head logits against the port's own monolithic
    prefill (same weights): every head's argmax and confidence."""
    from perfbench.harness.serve import arch_config
    from perfbench.harness.weights import make_weights
    from perfbench.reference import dense
    from repro_torch.models import model as model_lib

    cell = tiny_cell("stablelm-1.6b.generate")
    m = cell["config"]["port"]
    cfg = arch_config(m)
    w = make_weights(model_lib.init_params(cfg, None, "meta"), 11, "cpu")
    toks = np.random.default_rng(0).integers(0, m["vocab_size"], size=20)
    t = torch.as_tensor(toks)
    nxt, econf, etok, _ = model_lib.prefill(w, {"tokens": t[None].int()}, cfg, 24)
    logits = dense.head_logits(w, m, t, [19])
    heads = [(s, econf[:, b], etok[:, b]) for b, s in enumerate(m["exit_stages"])]
    for s, conf, tok in heads + [(m["num_stages"], None, nxt)]:
        gap, err = _readings(logits[s], tok, conf if conf is not None else torch.ones(1))
        assert gap <= TINY_LIMITS["token_gap"]
        if conf is not None:
            assert err <= TINY_LIMITS["conf_log_err"]


def _cut_after(monkeypatch, batches: int, in_flight_only: bool = False):
    """Close the window at the ``batches``-th stage batch, as the deadline
    closes it mid-slot on the card; returns the list the check's sample is
    put in (with ``in_flight_only``, the requests the cut left unfinished
    alone)."""
    from perfbench.harness import check, record

    real_on_batch, real_sample = record.Observer.on_batch, check.sample
    count, sampled = [0], []

    def on_batch(self, *a, **k):
        real_on_batch(self, *a, **k)
        count[0] += 1
        if count[0] >= batches:
            raise record.WindowClosed

    def sample(reqs, *a, **k):
        if in_flight_only:
            reqs = [q for q in reqs if not q["finished"]]
        sampled.extend(real_sample(reqs, *a, **k))
        return sampled

    monkeypatch.setattr(record.Observer, "on_batch", on_batch)
    monkeypatch.setattr(check, "sample", sample)
    return sampled


def test_requests_in_flight_are_judged(monkeypatch):
    sampled = _cut_after(monkeypatch, 24)
    r = run_tiny(tiny_cell("stablelm-1.6b.generate"))
    assert r["correct"], r["checks"]
    assert r["checks"]["missing"]["value"] == 0
    assert any(not q["finished"] and q["gen"] for q in sampled), sampled


@pytest.mark.parametrize("fault", ["generate-unchanged", "generate-half", "generate-token"])
def test_planted_fault_in_flight_is_not_correct(fault, monkeypatch):
    name, module, attr, make, mix = FAULTS[fault]
    sampled = _cut_after(monkeypatch, 24, in_flight_only=True)
    monkeypatch.setattr(module, attr, make(getattr(module, attr)))
    r = run_tiny(tiny_cell(name, **mix))
    assert not r["correct"], r["checks"]
    assert sampled and not any(q["finished"] for q in sampled)
