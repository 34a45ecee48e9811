"""Shared set-up of the differential tests between the JAX package and the
PyTorch port: one small stablelm config in both packages, and the JAX
weights bridged into the port."""
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


def configs():
    return (
        get_config("stablelm-1.6b").reduced(vocab_size=VOCAB),
        tconfigs.get_config("stablelm-1.6b").reduced(vocab_size=VOCAB),
    )


def bridged_params(seed: int = 0):
    """(jax params, port params on the CPU, jax cfg, port cfg) from one seed."""
    jcfg, tcfg = configs()
    jparams = jmodel.init_params(jax.random.key(seed), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jparams, tparams, jcfg, tcfg


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jax.numpy.asarray(x).astype(jax.numpy.float32))


def assert_bf16_close(got, want):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=BF16_RTOL, atol=BF16_ATOL)
