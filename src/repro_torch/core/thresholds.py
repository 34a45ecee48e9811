"""Early-exit confidence thresholds: the reuse-based accuracy-ratio table
(paper §3.1 last paragraph) and the coupled threshold update (Eqs. 17-18).

The key trick reproduced here: record every validation sample's per-branch
(confidence, correctness) ONCE; any threshold setting C is then evaluated by
pure screening — no re-inference.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.types import DtoHyperParams, ModelProfile


@dataclasses.dataclass(frozen=True)
class ExitEvaluation:
    accuracy: float
    # stage_remaining[h] == I_h for stages 0..H (I_0 = 1; non-exit stages 1).
    stage_remaining: np.ndarray
    # Fraction of *all* tasks exiting at each branch (early branches + final).
    exit_fraction: np.ndarray


@dataclasses.dataclass
class ExitProfile:
    """Recorded one-shot validation outputs for a partitioned model.

    conf[n, b] / correct[n, b]: confidence and correctness of sample n at
    branch b.  Branches are the early exits in stage order, then the final
    head.  ``branch_stage`` maps branch -> 1-indexed stage.
    """

    conf: np.ndarray
    correct: np.ndarray
    branch_stage: tuple[int, ...]
    num_stages: int

    # -- cached extremes ----------------------------------------------------
    def __post_init__(self) -> None:
        self.conf = np.asarray(self.conf, np.float64)
        self.correct = np.asarray(self.correct, bool)
        ones = np.ones(self.num_early_branches)
        zeros = np.zeros(self.num_early_branches)
        self.acc_max = self.evaluate(ones).accuracy  # nobody exits early
        self.acc_min = self.evaluate(zeros).accuracy  # everyone exits earliest

    @property
    def num_early_branches(self) -> int:
        return len(self.branch_stage) - 1

    def evaluate(self, thresholds: Sequence[float]) -> ExitEvaluation:
        """Screen the recorded outputs under thresholds (one per early branch).

        A sample exits at the first early branch with conf >= c_b; the rest
        exit at the final head.  I_h is the *conditional* continue fraction
        at stage h (paper's remaining ratio).
        """
        c = np.asarray(thresholds, np.float64)
        if c.shape[0] != self.num_early_branches:
            raise ValueError(
                f"expected {self.num_early_branches} thresholds, got {c.shape[0]}"
            )
        n = self.conf.shape[0]
        exited = np.zeros(n, bool)
        acc_sum = 0.0
        stage_remaining = np.ones(self.num_stages + 1, np.float64)
        exit_frac = np.zeros(len(self.branch_stage), np.float64)
        for b in range(self.num_early_branches):
            reached = ~exited
            n_reached = int(reached.sum())
            takes = reached & (self.conf[:, b] >= c[b])
            n_takes = int(takes.sum())
            stage = self.branch_stage[b]
            stage_remaining[stage] = (
                1.0 - n_takes / n_reached if n_reached > 0 else 1.0
            )
            acc_sum += float(self.correct[takes, b].sum())
            exit_frac[b] = n_takes / n
            exited |= takes
        rest = ~exited
        acc_sum += float(self.correct[rest, -1].sum())
        exit_frac[-1] = rest.sum() / n
        return ExitEvaluation(
            accuracy=acc_sum / n,
            stage_remaining=stage_remaining,
            exit_fraction=exit_frac,
        )

    def accuracy_ratio_table(self, grid: np.ndarray) -> dict[tuple[float, ...], ExitEvaluation]:
        """Joint accuracy-ratio table over a threshold grid (paper: computed
        once from the recorded softmax outputs and then reused)."""
        from itertools import product

        table = {}
        for combo in product(grid.tolist(), repeat=self.num_early_branches):
            table[tuple(round(x, 6) for x in combo)] = self.evaluate(combo)
        return table

    def normalized_accuracy(self, acc: float) -> float:
        """(A - A_min) / (A_max - A_min) as used by U(T, A) (Eq. 9)."""
        span = max(self.acc_max - self.acc_min, 1e-9)
        return (acc - self.acc_min) / span


def synthetic_validation(
    seed: int,
    profile: ModelProfile,
    num_samples: int = 4000,
    num_classes: int = 1000,
    difficulty_correlation: float = 0.85,
    confidence_gain: float = 3.0,
    confidence_noise: float = 1.5,
) -> ExitProfile:
    """Generate a synthetic one-shot validation record matching Table 2.

    Model: each sample carries a latent difficulty; branch b classifies it
    correctly with marginal probability == the branch accuracy A_b (Gaussian
    copula across branches so early-correct samples tend to stay correct).
    Confidence is a noisy, increasing function of the sample's margin
    (A_b - u), so thresholding on confidence selects easier samples — the
    mechanism that makes early exit accuracy-positive on easy inputs.
    """
    rng = np.random.default_rng(seed)
    exit_stages = list(profile.exit_stages) + [profile.num_stages]
    accs = np.array([profile.branch_accuracy[h - 1] for h in exit_stages], np.float64)
    B = accs.shape[0]

    z_shared = rng.standard_normal((num_samples, 1))
    z_local = rng.standard_normal((num_samples, B))
    rho = difficulty_correlation
    z = rho * z_shared + np.sqrt(1.0 - rho**2) * z_local
    # u ~ U(0,1) marginally (Gaussian copula): u[n,b] is sample n's
    # "effective difficulty" as seen by branch b.
    from math import erf

    u = 0.5 * (1.0 + np.vectorize(erf)(z / np.sqrt(2.0)))
    correct = u < accs[None, :]

    margin = accs[None, :] - u
    raw = confidence_gain * margin + confidence_noise * rng.standard_normal(
        (num_samples, B)
    )
    floor = 1.0 / num_classes
    conf = floor + (1.0 - floor) / (1.0 + np.exp(-raw))
    conf = np.clip(conf, floor, 1.0 - 1e-9)

    return ExitProfile(
        conf=conf,
        correct=correct,
        branch_stage=tuple(exit_stages),
        num_stages=profile.num_stages,
    )


# ---------------------------------------------------------------------------
# Coupled threshold adjustment (paper Eqs. 17-18, Alg. 3 lines 5-8).
# ---------------------------------------------------------------------------


def delay_impact(
    phi_stage_nodes: np.ndarray,
    omega_stage_nodes: np.ndarray,
    total_phi: float,
    I_h: float,
    I_h_new: float,
) -> float:
    """sum_i Delta D_i^h (Eq. 17) over the stage's nodes: early exit is
    'offloading to a virtual node', so scaling I rescales the downstream
    gradient Omega."""
    if I_h <= 1e-9 or total_phi <= 1e-12:
        # no load (e.g. a measured topology before any arrival lands in the
        # telemetry window): a threshold move cannot change the delay
        return 0.0
    scale = (I_h_new - I_h) / I_h
    return float(np.sum(phi_stage_nodes / total_phi * scale * omega_stage_nodes))


@dataclasses.dataclass(frozen=True)
class ThresholdDecision:
    thresholds: np.ndarray
    stage_remaining: np.ndarray
    accuracy: float
    delta_u: float
    changed: bool


def threshold_step(
    exit_profile: ExitProfile,
    thresholds: np.ndarray,
    branch_index: int,
    phi_stage_nodes: np.ndarray,
    omega_stage_nodes: np.ndarray,
    total_phi: float,
    hyper: DtoHyperParams,
) -> ThresholdDecision:
    """Try c_h +/- tau_c for one branch; apply the move minimizing Delta U
    if Delta U < 0 (Alg. 3 lines 6-8).

    Note: Omega here must NOT include the receiver-side penalty explosion of
    an infeasible state beyond what Eq. 15 already carries — we pass whatever
    the DTO-O round computed, exactly as the distributed algorithm would.
    """
    base = exit_profile.evaluate(thresholds)
    stage = exit_profile.branch_stage[branch_index]
    best = ThresholdDecision(
        thresholds=thresholds.copy(),
        stage_remaining=base.stage_remaining,
        accuracy=base.accuracy,
        delta_u=0.0,
        changed=False,
    )
    for step in (+hyper.tau_c, -hyper.tau_c):
        cand = thresholds.copy()
        cand[branch_index] = float(np.clip(cand[branch_index] + step, 0.0, 1.0))
        if cand[branch_index] == thresholds[branch_index]:
            continue
        ev = exit_profile.evaluate(cand)
        dd = delay_impact(
            phi_stage_nodes,
            omega_stage_nodes,
            total_phi,
            I_h=float(base.stage_remaining[stage]),
            I_h_new=float(ev.stage_remaining[stage]),
        )
        d_acc_norm = exit_profile.normalized_accuracy(
            ev.accuracy
        ) - exit_profile.normalized_accuracy(base.accuracy)
        du = hyper.utility_a * dd - (1.0 - hyper.utility_a) * d_acc_norm
        if du < best.delta_u:
            best = ThresholdDecision(
                thresholds=cand,
                stage_remaining=ev.stage_remaining,
                accuracy=ev.accuracy,
                delta_u=du,
                changed=True,
            )
    return best
