"""Synthetic data: the counterpart of ``repro.data.pipeline`` (its numpy,
copied).

Training: an infinite deterministic token stream, seeded by ``(seed,
step)``, so a resumed run sees bit for bit the batches it would have seen
(the checkpoint records the step; no cursor state is stored).  Batches are
made on the host and copied to ``device``; with a device ``mesh`` each leaf
arrives as a DTensor sharded on its batch dim over ("pod", "data").

Serving: Poisson arrivals of prompts with lognormal lengths.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 512
    seed: int = 0


def _batch_for_step(cfg: ArchConfig, dcfg: DataConfig, step: int) -> dict:
    """Deterministic synthetic LM batch for a given step (host-side numpy)."""
    rng = np.random.default_rng((dcfg.seed, step))
    B, S = dcfg.batch_size, dcfg.seq_len
    if cfg.frontend == "embeds":
        embeds = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32) * 0.02
        labels = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
        return {"embeds": embeds, "labels": labels}
    # Markov-ish stream so the LM loss has learnable structure
    base = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    shifted = np.roll(base, 1, axis=1)
    mix = rng.random((B, S)) < 0.5
    tokens = np.where(mix, base, (shifted * 31 + 7) % cfg.vocab_size).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1  # mask the wrap-around position
    return {"tokens": tokens, "labels": labels}


def token_stream(cfg: ArchConfig, dcfg: DataConfig, start_step: int = 0,
                 device="cuda", mesh=None) -> Iterator[dict]:
    """Infinite stream of batches from ``start_step`` on, as tensors on
    ``device`` (tokens and labels int32, embeddings f32).  With a
    ``DeviceMesh``, each leaf is a DTensor on the mesh's device, its batch
    dim sharded over whichever of ("pod", "data") the mesh has: every rank
    cuts its own rows from the same seeded host batch (no global concat)."""
    from repro_torch.sharding import PartitionSpec, distribute

    axes = None
    if mesh is not None:
        names = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
        axes = names if len(names) > 1 else (names[0] if names else None)
        device = mesh.device_type
    step = start_step
    while True:
        host = _batch_for_step(cfg, dcfg, step)
        if mesh is None:
            yield {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        else:
            yield {k: distribute(torch.from_numpy(v),
                                 PartitionSpec(axes, *([None] * (v.ndim - 1))), mesh,
                                 device=device)
                   for k, v in host.items()}
        step += 1


@dataclasses.dataclass(frozen=True)
class RequestConfig:
    arrival_rate: float = 20.0  # tasks/s across the system
    mean_prompt_len: int = 64
    sigma: float = 0.4
    seed: int = 0


def poisson_requests(
    cfg: ArchConfig, rcfg: RequestConfig, duration: float
) -> list[tuple[float, np.ndarray]]:
    """[(arrival_time, prompt_tokens)] over ``duration`` seconds."""
    rng = np.random.default_rng(rcfg.seed)
    out = []
    t = rng.exponential(1.0 / rcfg.arrival_rate)
    while t < duration:
        n = max(2, int(rng.lognormal(np.log(rcfg.mean_prompt_len), rcfg.sigma)))
        prompt = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        out.append((float(t), prompt))
        t += rng.exponential(1.0 / rcfg.arrival_rate)
    return out
