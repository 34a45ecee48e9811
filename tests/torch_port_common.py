"""Shared set-up of the differential tests between the JAX package and the
PyTorch port: one small config in both packages (stablelm-1.6b unless a
test names another), the JAX weights bridged into the port, and a pair of
serving engines built from them."""
import functools

import numpy as np
import torch

import jax

from repro.configs import get_config
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.models import bridge

# At these widths a CPU op is microseconds of work; with a pool of threads
# per op, bf16 matmuls spend milliseconds in thread hand-off instead
torch.set_num_threads(1)

VOCAB = 128
# stated tolerances: f32 math, and bf16 results (the two frameworks round
# bf16 at different places)
F32_ATOL = 2e-5
BF16_RTOL, BF16_ATOL = 1.6e-2, 1e-2


def configs(arch: str = "stablelm-1.6b"):
    return (
        get_config(arch).reduced(vocab_size=VOCAB),
        tconfigs.get_config(arch).reduced(vocab_size=VOCAB),
    )


@functools.lru_cache(maxsize=None)
def bridged_params(seed: int = 0, arch: str = "stablelm-1.6b"):
    """(jax params, port params on the CPU, jax cfg, port cfg) from one seed;
    made once per process (nothing mutates them)."""
    jcfg, tcfg = configs(arch)
    jparams = jmodel.init_params(jax.random.key(seed), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jparams, tparams, jcfg, tcfg


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jax.numpy.asarray(x).astype(jax.numpy.float32))


def step_batch(cfg, rng: np.random.Generator, B: int, S: int, tokens=None):
    """One batch for both packages' batched steps, as ``(jax batch, port
    batch)``: for a token frontend ``tokens`` [B, S] (drawn when None); for
    ``frontend="embeds"`` embeddings ``N(0, 1) * 0.1`` in bf16, as
    ``tests/test_models_smoke.py``'s ``_batch``."""
    if cfg.frontend == "embeds":
        e = (rng.standard_normal((B, S, cfg.d_model)) * 0.1).astype(np.float32)
        return ({"embeds": jax.numpy.asarray(e, jax.numpy.bfloat16)},
                {"embeds": torch.from_numpy(e).bfloat16()})
    if tokens is None:
        tokens = rng.integers(0, cfg.vocab_size, (B, S))
    tokens = np.array(tokens, np.int32)  # a writable copy
    return {"tokens": jax.numpy.asarray(tokens)}, {"tokens": torch.from_numpy(tokens).long()}


def assert_bf16_close(got, want):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=BF16_RTOL, atol=BF16_ATOL)


def engine_pair(threshold: float, arch: str = "stablelm-1.6b", capacity_scale: float = 1.0):
    """(JAX engine, port engine on the CPU) over the same bridged weights and
    edge network (replica capacities scaled by ``capacity_scale``).  The
    port takes the JAX engine's strategy ``p`` and both take ``threshold``
    at every exit branch, so control-plane float drift cannot move routing."""
    from repro.core.profiles import profile_from_arch as jprofile
    from repro.core.thresholds import synthetic_validation as jvalidation
    from repro.core.topology import NetworkSpec as JSpec
    from repro.core.topology import build_edge_network as jnetwork
    from repro.core.types import DtoHyperParams as JHyper
    from repro.serving import CollaborativeEngine as JEngine
    from repro_torch.core.profiles import profile_from_arch as tprofile
    from repro_torch.core.thresholds import synthetic_validation as tvalidation
    from repro_torch.core.topology import NetworkSpec as TSpec
    from repro_torch.core.topology import build_edge_network as tnetwork
    from repro_torch.core.types import DtoHyperParams as THyper
    from repro_torch.serving import CollaborativeEngine as TEngine

    jparams, tparams, jcfg, tcfg = bridged_params(0, arch)
    jp, tp = jprofile(jcfg), tprofile(tcfg)
    jeng = JEngine(
        jparams, jcfg, jnetwork(seed=0, profile=jp, spec=JSpec(num_eds=4, es_per_stage=(2, 2)),
                                capacity_scale=capacity_scale),
        jp, jvalidation(seed=1, profile=jp), JHyper(rounds=20), seed=0,
    )
    jeng.configuration_phase()
    jeng.state.thresholds = np.full_like(jeng.state.thresholds, threshold)
    teng = TEngine(
        tparams, tcfg, tnetwork(seed=0, profile=tp, spec=TSpec(num_eds=4, es_per_stage=(2, 2)),
                                capacity_scale=capacity_scale),
        tp, tvalidation(seed=1, profile=tp), THyper(rounds=20), seed=0, device="cpu",
    )
    teng.configuration_phase()
    teng.state.carry = teng.state.carry._replace(p=torch.from_numpy(np.array(jeng.state.carry.p)))
    teng.state.thresholds = jeng.state.thresholds.copy()
    return jeng, teng
