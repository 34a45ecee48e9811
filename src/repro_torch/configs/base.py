"""ArchConfig — the description every subsystem of the port consumes.

The counterpart of ``repro.configs.base``.  A model is a cycled ``period`` of
block kinds, partitioned into ``num_stages`` pipeline stages at period
granularity, with early-exit heads after the stages named in
``exit_stages`` (1-indexed).

The port runs dense GQA attention blocks (``"attn"``) only so far; the MLA,
MoE, SSM and sliding-window variants arrive with their blocks (ROADMAP
queue 1, item 12), and this class rejects them until then.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models.attention import AttnDims

BLOCK_KINDS = ("attn",)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    norm: str = "rmsnorm"
    act: str = "silu"
    ffn: str = "glu"  # "glu" (SwiGLU-style) | "mlp" (classic 2-matmul)
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int | None = None
    period: tuple[str, ...] = ("attn",)
    frontend: str = "tokens"
    num_stages: int = 4
    exit_stages: tuple[int, ...] = (2, 3)
    exit_loss_weight: float = 0.3
    sub_quadratic: bool = False
    q_chunk: int = 1024
    dtype: Any = torch.bfloat16
    notes: str = ""

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        for kind in self.period:
            if kind not in BLOCK_KINDS:
                raise NotImplementedError(
                    f"block kind {kind!r} is not ported yet (ROADMAP queue 1, item 12)"
                )
        if self.sliding_window is not None:
            raise NotImplementedError(
                "sliding-window caches are not ported yet (ROADMAP queue 1, item 12)"
            )
        if self.ffn != "glu":
            raise NotImplementedError(
                "the two-matmul MLP FFN is not ported yet (ROADMAP queue 1, item 12)"
            )
        if self.frontend != "tokens":
            raise NotImplementedError(
                "the embeds frontend is not ported yet (ROADMAP queue 1, item 12)"
            )
        if self.num_layers % len(self.period) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"period length {len(self.period)}"
            )
        bad = [h for h in self.exit_stages if not (1 <= h < self.num_stages)]
        if bad:
            raise ValueError(f"exit stages {bad} out of range 1..{self.num_stages - 1}")

    @property
    def num_periods(self) -> int:
        return self.num_layers // len(self.period)

    def stage_periods(self) -> list[int]:
        """Periods per stage (near-even split, earlier stages get extras)."""
        return [len(a) for a in np.array_split(np.arange(self.num_periods), self.num_stages)]

    def attn_dims(self) -> AttnDims:
        return AttnDims(
            d_model=self.d_model,
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim,
            qkv_bias=self.qkv_bias,
            rope_theta=self.rope_theta,
            sliding_window=self.sliding_window,
        )

    def reduced(self, **overrides) -> "ArchConfig":
        """A smoke-test-sized sibling: same family/period structure, tiny dims
        (the dense-attention branch of ``repro.configs.base.ArchConfig.reduced``)."""
        n_periods = max(self.num_stages, 4)
        small: dict[str, Any] = dict(
            num_layers=n_periods * len(self.period),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads else 4,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32,
            q_chunk=64,
        )
        small.update(overrides)
        return dataclasses.replace(self, name=f"{self.name}-smoke", **small)
