"""Serving request streams: the serving half of ``repro.data.pipeline``
(pure numpy, copied).  The training token pipeline is not ported yet."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig


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
