"""Core datatypes for the DTO-EE control plane.

Units convention (keeps penalty / delay terms numerically sane):
  - compute        : GFLOPs (alpha) and GFLOP/s (mu, lam)
  - data sizes     : MB (beta)
  - bandwidth      : MB/s (edge rates)
  - time           : seconds
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Per-stage cost/accuracy profile of a partitioned model (paper Table 2).

    Stages are 1-indexed in the paper (``M_1 .. M_H``); arrays here are
    0-indexed with entry ``h-1`` describing sub-model ``M_h``.
    """

    name: str
    # GFLOPs required to run sub-model M_h on one task (paper: alpha_h).
    alpha: tuple[float, ...]
    # Input size of sub-model M_h in MB (paper: beta_h). beta[0] is the size
    # of the raw task payload shipped from the ED.
    beta: tuple[float, ...]
    # exit_stage[h-1] == True iff sub-model M_h carries an exit branch b_h.
    has_exit: tuple[bool, ...]
    # Accuracy of the prediction made at stage h (exit branches and the
    # final head). Non-exit, non-final stages carry 0.0 placeholders.
    branch_accuracy: tuple[float, ...]

    def __post_init__(self) -> None:
        H = len(self.alpha)
        if not (len(self.beta) == len(self.has_exit) == len(self.branch_accuracy) == H):
            raise ValueError("profile arrays must share length H")
        if self.has_exit[-1]:
            raise ValueError("final stage is the mandatory exit; has_exit marks early branches only")

    @property
    def num_stages(self) -> int:
        return len(self.alpha)

    @property
    def exit_stages(self) -> tuple[int, ...]:
        """1-indexed stages carrying early-exit branches."""
        return tuple(h + 1 for h, e in enumerate(self.has_exit) if e)

    @property
    def total_gflops(self) -> float:
        return float(sum(self.alpha))


# ---------------------------------------------------------------------------
# Paper Table 2 profiles.
# ---------------------------------------------------------------------------

# ResNet101 split into 4 sub-models; exit branches on M_2 and M_3.
# beta_1 (the compressed input image) is not listed in Table 2; we use
# 0.15 MB (JPEG-compressed ImageNet sample), see DESIGN.md §9.
RESNET101_PROFILE = ModelProfile(
    name="resnet101",
    alpha=(2.21, 1.97, 1.97, 1.68),
    beta=(0.15, 0.77, 0.77, 0.77),
    has_exit=(False, True, True, False),
    branch_accuracy=(0.0, 0.470, 0.582, 0.681),
)

# BERT-large split into 5 sub-models; exit branches on M_2, M_3, M_4.
BERT_PROFILE = ModelProfile(
    name="bert",
    alpha=(6.44, 8.05, 8.08, 8.08, 8.08),
    beta=(0.01, 0.56, 0.56, 0.56, 0.56),
    has_exit=(False, True, True, True, False),
    branch_accuracy=(0.0, 0.552, 0.568, 0.572, 0.582),
)


@dataclasses.dataclass
class Topology:
    """A staged edge network in CSR-ish array form.

    Nodes ``0..num_nodes-1``.  ``node_stage[v] == 0`` marks an ED; stages
    ``1..H`` mark ESs holding sub-model ``M_h``.  Directed edges run only
    from stage ``h`` to stage ``h+1`` (the paper's pipeline arrangement).

    Edges are sorted by (src, dst); ``edge_offsets`` is the CSR row pointer
    over sources, so the successor set L_i of node i is
    ``edges[edge_offsets[i]:edge_offsets[i+1]]``.
    """

    node_stage: np.ndarray  # int32 [N]
    mu: np.ndarray  # float64 [N]  GFLOP/s (EDs: np.inf — they do not compute)
    phi_ext: np.ndarray  # float64 [N] external Poisson arrival rate; 0 for ESs
    edge_src: np.ndarray  # int32 [E]
    edge_dst: np.ndarray  # int32 [E]
    edge_rate: np.ndarray  # float64 [E]  MB/s
    edge_offsets: np.ndarray  # int32 [N+1] CSR over sources

    def __post_init__(self) -> None:
        self.node_stage = np.asarray(self.node_stage, np.int32)
        self.mu = np.asarray(self.mu, np.float64)
        self.phi_ext = np.asarray(self.phi_ext, np.float64)
        self.edge_src = np.asarray(self.edge_src, np.int32)
        self.edge_dst = np.asarray(self.edge_dst, np.int32)
        self.edge_rate = np.asarray(self.edge_rate, np.float64)
        self.edge_offsets = np.asarray(self.edge_offsets, np.int32)

    # -- sizes ------------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return int(self.node_stage.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_src.shape[0])

    @property
    def num_stages(self) -> int:
        return int(self.node_stage.max())

    # -- views ------------------------------------------------------------
    def successors(self, v: int) -> np.ndarray:
        lo, hi = self.edge_offsets[v], self.edge_offsets[v + 1]
        return self.edge_dst[lo:hi]

    def out_edges(self, v: int) -> np.ndarray:
        lo, hi = self.edge_offsets[v], self.edge_offsets[v + 1]
        return np.arange(lo, hi, dtype=np.int32)

    def nodes_at_stage(self, h: int) -> np.ndarray:
        return np.nonzero(self.node_stage == h)[0].astype(np.int32)

    def out_degree(self) -> np.ndarray:
        return np.diff(self.edge_offsets)

    def validate(self) -> None:
        """Structural invariants: staged edges, sorted CSR, offloaders covered."""
        if self.edge_offsets.shape[0] != self.num_nodes + 1:
            raise ValueError("edge_offsets must have N+1 entries")
        if not np.all(np.diff(self.edge_offsets) >= 0):
            raise ValueError("edge_offsets must be monotone")
        src_stage = self.node_stage[self.edge_src]
        dst_stage = self.node_stage[self.edge_dst]
        if not np.all(dst_stage == src_stage + 1):
            raise ValueError("edges must connect stage h to stage h+1")
        # every LIVE node below the final stage must have >= 1 successor
        # (dead ESs keep their slot with mu ~ 0 and no edges; idle EDs with
        # no arrivals need none either)
        H = self.num_stages
        deg = self.out_degree()
        live_es = (self.node_stage > 0) & (self.mu > 1e-6)
        live_ed = (self.node_stage == 0) & (self.phi_ext > 0)
        need = (self.node_stage < H) & (live_es | live_ed)
        if not np.all(deg[need] >= 1):
            raise ValueError("every live non-final node needs at least one successor")
        if np.any(self.mu[self.node_stage > 0] <= 0):
            raise ValueError("ES capacity must be positive")
        if np.any(self.edge_rate <= 0):
            raise ValueError("edge rates must be positive")


@dataclasses.dataclass(frozen=True)
class DtoHyperParams:
    """Hyper-parameters of Algorithms 1-3."""

    tau_p: float = 0.15  # offloading step size (Eq. 19)
    tau_c: float = 0.05  # confidence-threshold step size
    penalty_k: float = 10.0  # exterior-point penalty factor K (Eq. 11)
    penalty_eps: float = 1e-3  # epsilon in Eq. 11
    rounds: int = 50  # communication rounds n per configuration phase
    threshold_every: int = 5  # update frequency m (Alg. 3 line 5)
    utility_a: float = 0.85  # weight a in U(T, A) (Eq. 9); delay in s vs acc in [0,1]

    def __post_init__(self) -> None:
        if not (0.0 < self.tau_p <= 1.0):
            raise ValueError("tau_p must lie in (0, 1]")


def stage_index_arrays(topo: Topology) -> list[np.ndarray]:
    """Edge indices grouped by source stage: groups[h] = edges with src at stage h."""
    src_stage = topo.node_stage[topo.edge_src]
    return [np.nonzero(src_stage == h)[0].astype(np.int32) for h in range(topo.num_stages)]
