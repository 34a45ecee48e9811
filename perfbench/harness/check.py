"""How ``correct`` is decided: what the timed serve produced, held to the
plain reference (``perfbench.reference.dense``) after the window.

The requests judged: every request the window's serves finished, and every
request still in flight when the window closed that a head had already
answered (its served tokens so far are its final head's tokens at the
passes whose token was emitted).  The sample: the longest of them (prompt
plus passes) first, then others drawn from the seed, each with a weight
that falls with the reference's FLOPs for it, so that many short ones come
before a few long ones, while those FLOPs stay within the mix's
``check.tflop`` and the count within ``check.max_requests``.  For each,
the reference runs once over the prompt and the served tokens (teacher
forced) and gives every head's logits at the positions the program's heads
read (one a pass: the prompt's last, then each fed-back token's).

The numbers compared, each the worst over the sample:

* ``token_gap``: how far below the reference's best logit a token's logit
  lies, in units of the standard deviation of that position's reference
  logits.  The tokens: every served token (under the head it was served
  from), and the argmax of every exit head and of the final head at every
  pass (the exit heads' tokens are served only when a request exits early,
  which random weights never do; the check reads them anyway);
* ``conf_log_err``: ``|log conf - log conf_ref|`` of every head output's
  confidence (the top softmax probability) and of each finished request's
  served confidence;
* ``missing``: head outputs and served tokens that a request should have
  and the program did not produce (an exact count).  A finished request
  has one output a pass at each head its passes reached; one in flight has
  a final-head output for each emitted token (and at most one more, the
  pass the window cut), and at each exit head at least as many as at the
  final head and at most one a pass.

``control`` computes the same numbers for the reference in fp8
(``precision="fp8"``), put in the program's place: the token it puts first
and its confidence at every head and position.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.harness.flops import pass_flops
from perfbench.reference import dense

NUMBERS = ("token_gap", "conf_log_err", "missing")


def served_requests(obs, gen_len: int, final_stage: int) -> list[dict]:
    """Every request of the window's serves that a head answered: slot,
    rid, prompt length, ``finished``, served tokens (``gen``), ``passes``
    (the positions its heads read), and its head outputs by stage (lists of
    (conf, tok) in pass order); a finished one also has its exit stage and
    served confidence."""
    heads: dict[tuple, dict[int, list]] = {}
    for slot, stage, rids, conf, tok in obs.heads:
        n = len(rids)
        c, t = conf[:n].float().cpu().numpy(), tok[:n].cpu().numpy()
        for i, r in enumerate(rids):
            heads.setdefault((slot, r), {}).setdefault(stage, []).append((float(c[i]), int(t[i])))
    out, finished = [], set()
    for slot, st in obs.stats.items():
        for rid, stage, conf, gen in zip(st.rids, st.exit_stage, st.confidences, st.gen_tokens):
            finished.add((slot, rid))
            out.append({"slot": slot, "rid": rid, "finished": True, "exit_stage": int(stage),
                        "conf": float(conf), "gen": [int(x) for x in gen], "passes": len(gen),
                        "heads": heads.get((slot, rid), {}),
                        "prompt_len": obs.prompt_lens[slot][rid]})
    for (slot, rid), hs in heads.items():
        if (slot, rid) in finished:
            continue
        n = obs.emitted.get((slot, rid), 0)
        final = hs.get(final_stage, [])
        out.append({"slot": slot, "rid": rid, "finished": False, "emitted": n,
                    "gen": [t for _, t in final[:n]], "passes": min(n + 1, gen_len),
                    "heads": hs, "prompt_len": obs.prompt_lens[slot][rid]})
    return out


def sample(reqs: list[dict], model: dict, check: dict, seed: int) -> list[dict]:
    if not reqs:
        return []
    cost = np.array([pass_flops(model, 0, r["prompt_len"] + max(r["passes"] - 1, 0))
                     for r in reqs])
    first = int(np.argmax(cost))
    budget = float(check["tflop"]) * 1e12
    chosen, spent = [reqs[first]], cost[first]
    weight = 1.0 / cost
    order = np.random.default_rng((int(seed), 17)).choice(
        len(reqs), size=len(reqs), replace=False, p=weight / weight.sum())
    for i in order:
        if len(chosen) >= int(check["max_requests"]):
            break
        if i != first and spent + cost[i] <= budget:
            chosen.append(reqs[i])
            spent += cost[i]
    return chosen


def _readings(ref: torch.Tensor, toks: torch.Tensor, confs: torch.Tensor):
    """(worst normalised gap, worst |log conf - log conf_ref|) of tokens
    ``toks`` [n] and confidences ``confs`` [n] under reference logits
    ``ref`` [n, V]."""
    best = ref.max(dim=-1).values
    gap = (best - ref.gather(1, toks[:, None].long())[:, 0]) / ref.std(dim=-1)
    log_conf_ref = best - torch.logsumexp(ref, dim=-1)
    err = (confs.double().log() - log_conf_ref.double()).abs()
    return float(gap.max()), float(err.max())


def compare(weights, model: dict, mix: dict, sampled: list[dict], prompts_of,
            device, control: bool = False) -> dict:
    """The numbers of ``NUMBERS`` over ``sampled`` (and, with ``control``,
    the fp8 control's ``token_gap`` and ``conf_log_err`` on the same
    sequences, under ``control_*``)."""
    H = model["num_stages"]
    head_stages = list(model["exit_stages"]) + [H]
    gen_len = int(mix["gen_len"])
    out = {"token_gap": 0.0, "conf_log_err": 0.0, "missing": 0}
    if control:
        out.update(control_token_gap=0.0, control_conf_log_err=0.0)
    for r in sampled:
        prompt = prompts_of(r["slot"])[r["rid"]]
        gen, passes = r["gen"], r["passes"]
        n = len(gen)
        if r["finished"]:
            exited_early = r["exit_stage"] != H
            if n == 0 or (n < gen_len and not exited_early):
                out["missing"] += max(gen_len - n, 1)
                continue
            # one output a pass at each head the pass reached
            want = {s: (n - 1 if exited_early and s > r["exit_stage"] else n,) * 2
                    for s in head_stages}
        else:
            out["missing"] += r["emitted"] - n  # emitted tokens no final head produced
            got_final = len(r["heads"].get(H, []))
            want = {s: (got_final if s != H else n, passes) for s in head_stages}
        seq = np.concatenate([np.asarray(prompt, np.int64),
                              np.asarray(gen[:passes - 1], np.int64)])
        L = int(prompt.shape[0])
        positions = np.arange(L - 1, L - 1 + passes)
        tokens = torch.as_tensor(seq, device=device)
        ref = dense.head_logits(weights, model, tokens, positions, "f32")
        gaps, errs = [], []
        if r["finished"]:
            # served tokens, each under the head it was served from
            for k, tok in enumerate(gen):
                stage = r["exit_stage"] if k == n - 1 else H
                g, _ = _readings(ref[stage][k:k + 1], torch.tensor([tok], device=device),
                                 torch.ones(1, device=device))
                gaps.append(g)
            _, e = _readings(ref[r["exit_stage"]][n - 1:n],
                             torch.tensor([gen[-1]], device=device),
                             torch.tensor([r["conf"]], device=device))
            errs.append(e)
        # every head output at every pass that reached its stage
        for s in head_stages:
            got = r["heads"].get(s, [])
            lo, hi = want[s]
            out["missing"] += max(lo - len(got), 0) + max(len(got) - hi, 0)
            m = min(hi, len(got))
            if m == 0:
                continue
            conf = torch.tensor([c for c, _ in got[:m]], device=device)
            tok = torch.tensor([t for _, t in got[:m]], device=device)
            g, e = _readings(ref[s][:m], tok, conf)
            gaps.append(g)
            errs.append(e)
        out["token_gap"] = max([out["token_gap"]] + gaps)
        out["conf_log_err"] = max([out["conf_log_err"]] + errs)
        if control:
            ctl = dense.head_logits(weights, model, tokens, positions, "fp8")
            for s in head_stages:
                c_best = ctl[s].max(dim=-1)
                c_conf = torch.exp(c_best.values - torch.logsumexp(ctl[s], dim=-1))
                g, e = _readings(ref[s], c_best.indices, c_conf)
                out["control_token_gap"] = max(out["control_token_gap"], g)
                out["control_conf_log_err"] = max(out["control_conf_log_err"], e)
            del ctl
        del ref
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number of
    ``NUMBERS`` is within its limit (a number that is not finite is not)."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in shown.values())
    return ok, shown
