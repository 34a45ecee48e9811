"""ArchConfig — the description every subsystem of the port consumes.

The counterpart of ``repro.configs.base``.  A model is a cycled ``period`` of
block kinds, partitioned into ``num_stages`` pipeline stages at period
granularity, with early-exit heads after the stages named in
``exit_stages`` (1-indexed).

The port runs every block kind of the reference: attention blocks with a
GLU FFN (``"attn"``, and zamba2's ``"dense_attn"``, which runs as ``"attn"``
does) or a mixture-of-experts FFN (``"moe_attn"``), each with GQA or, where
``mla`` is set, DeepSeek's multi-head latent attention; Mamba2 blocks
(``"mamba"``, with ``mamba`` dims); and xLSTM's ``"mlstm"`` and ``"slstm"``
blocks (with ``xlstm`` dims).  Attention may take a sliding window
(``sliding_window``: the monolithic steps then keep a ring cache of that
many keys), the FFN may be the two-matmul ``"mlp"`` (with ``act="gelu"``,
the tanh approximation), and ``frontend="embeds"`` feeds precomputed
embeddings ``[B, S, d_model]`` instead of tokens (the model then has no
embedding table).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models.attention import AttnDims, MlaDims
from repro_torch.models.moe import MoeDims
from repro_torch.models.ssm import MambaDims, XlstmDims

BLOCK_KINDS = ("attn", "moe_attn", "mamba", "dense_attn", "mlstm", "slstm")
# the dims each kind needs besides the attention fields
_KIND_DIMS = {"moe_attn": "moe", "mamba": "mamba", "mlstm": "xlstm", "slstm": "xlstm"}


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
    moe: MoeDims | None = None
    mla: MlaDims | None = None
    mamba: MambaDims | None = None
    xlstm: XlstmDims | None = None
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
                raise ValueError(f"unknown block kind {kind!r}")
            dims = _KIND_DIMS.get(kind)
            if dims is not None and getattr(self, dims) is None:
                raise ValueError(f"{self.name}: a {kind!r} period needs {dims} dims")
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

    @property
    def uses_attention(self) -> bool:
        return any(k in ("attn", "moe_attn", "dense_attn") for k in self.period)

    def param_count(self, active_only: bool = False) -> int:
        """Parameters of the model; ``active_only`` counts the top-k routed
        experts of each MoE block instead of all of them."""
        from repro_torch.models import model as model_lib

        return model_lib.count_params(self, active_only=active_only)

    def reduced(self, **overrides) -> "ArchConfig":
        """A smoke-test-sized sibling: same family/period structure, tiny dims
        (``repro.configs.base.ArchConfig.reduced``)."""
        n_periods = max(self.num_stages, 4)
        small: dict[str, Any] = dict(
            num_layers=n_periods * len(self.period),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads else 4,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32,
            sliding_window=32 if self.sliding_window else None,
            q_chunk=64,
        )
        if self.moe is not None:
            small["moe"] = dataclasses.replace(
                self.moe,
                d_model=128,
                d_ff_expert=64,
                num_experts=min(self.moe.num_experts, 8),
                d_ff_shared=64 if self.moe.num_shared else 0,
                top_k=min(self.moe.top_k, 2),
            )
        if self.mla is not None:
            small["mla"] = MlaDims(
                d_model=128,
                num_heads=4,
                kv_lora_rank=32,
                qk_nope_head_dim=32,
                qk_rope_head_dim=16,
                v_head_dim=32,
            )
            small["head_dim"] = 32
        if self.mamba is not None:
            small["mamba"] = dataclasses.replace(
                self.mamba, d_model=128, d_state=16, head_dim=32, chunk=16
            )
        if self.xlstm is not None:
            small["xlstm"] = dataclasses.replace(self.xlstm, d_model=128, num_heads=4, chunk=16)
        small.update(overrides)
        return dataclasses.replace(self, name=f"{self.name}-smoke", **small)
