"""Shared set-up of the training tests between the JAX package and the
PyTorch port: a reduced config in both packages, the JAX f32 masters bridged
into the port (``master=True``), one seeded batch for both, and norm-wise
comparisons of gradient trees."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.models import bridge

from torch_port_common import VOCAB  # noqa: F401  (sets torch to one thread)

ARCHS = (
    "stablelm-1.6b", "glm4-9b", "internlm2-20b", "qwen2.5-32b", "deepseek-v2-lite-16b",
    "mixtral-8x7b", "zamba2-2.7b", "xlstm-350m", "phi-3-vision-4.2b", "musicgen-medium",
)
B, S = 2, 32
# the stated gradient tolerance: norm-wise 2^-7 per leaf, as the full-width
# block gates on the card
GRAD_RTOL = 2.0**-7


def configs(arch: str):
    return (get_config(arch).reduced(vocab_size=VOCAB),
            tconfigs.get_config(arch).reduced(vocab_size=VOCAB))


def master_params(arch: str, seed: int = 0):
    """(jax f32 params, the same as the port's f32 masters on the CPU, jcfg, tcfg)."""
    jcfg, tcfg = configs(arch)
    jparams = jmodel.init_params(jax.random.key(seed), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu",
                                       master=True)
    return jparams, tparams, jcfg, tcfg


def train_batch(cfg, seed: int = 0, masked: int = 3):
    """One training batch for both packages, ``(jax batch, port batch)``:
    tokens (or, for ``frontend="embeds"``, bf16 embeddings N(0, 1) * 0.1)
    and labels, the last ``masked`` positions of every row at -1."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, S - masked:] = -1
    if cfg.frontend == "embeds":
        e = (rng.standard_normal((B, S, cfg.d_model)) * 0.1).astype(np.float32)
        jb, tb = {"embeds": jnp.asarray(e, jnp.bfloat16)}, {"embeds": torch.from_numpy(e).bfloat16()}
    else:
        t = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        jb, tb = {"tokens": jnp.asarray(t)}, {"tokens": torch.from_numpy(t)}
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    return jb, tb


def rel_err(want, got) -> float:
    """||got - want|| / ||want|| in f64 (0 when both are zero)."""
    a = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    b = got.detach().double().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    den = np.linalg.norm(a)
    return float(np.linalg.norm(a - b) / den) if den > 0 else float(np.abs(b).max(initial=0.0))


def named_leaves(tree) -> list[tuple[str, object]]:
    """(``/``-joined path, leaf) in JAX's leaf order (dict keys sorted)."""
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def torch_leaves_like(tree) -> list:
    """The port tree's leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in torch_leaves_like(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in torch_leaves_like(v)]
    return [tree]
