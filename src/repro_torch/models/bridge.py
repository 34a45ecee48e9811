"""Weight bridge: the JAX package's parameter tree, as numpy, to the port's.

``params_from_numpy(jax.tree.map(np.asarray, params), cfg, device)`` gives
the port the reference's exact weights, so the two packages can be held to
each other without matching random generators.  The port never sees a JAX
array: the caller converts on its side.  Weight matrices become bf16 (the
reference casts them to bf16 at every matmul); norm scales, norm biases and
QKV biases stay f32.  The tree is walked by leaf name, so the MoE
``experts`` stacks and ``shared`` GLU, the router, MLA's projections and
the recurrent blocks' projections and conv kernels become bf16 like every
other name in ``BF16_LEAVES``, and MLA's ``norm_ckv`` scale, the recurrent
blocks' decay, skip, bias and gate leaves and sLSTM's ``r_gates`` (cast to
its f32 state's dtype in the reference) stay f32.  An embeds config's tree
(no ``embed`` table) and the MLP FFN's ``w_up``/``w_down`` need nothing of
their own.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import BF16_LEAVES


def _convert(tree: Any, name: str, device, master: bool) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, k, device, master) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, name, device, master) for v in tree)
    dtype = torch.bfloat16 if name in BF16_LEAVES and not master else torch.float32
    return torch.from_numpy(np.array(tree, np.float32)).to(device=device, dtype=dtype)


def params_from_numpy(tree: Any, cfg: ArchConfig, device="cuda", master: bool = False) -> Any:
    """The port's parameters from the reference tree of numpy arrays; with
    ``master=True`` every leaf stays f32 (the reference's training masters,
    ``models.model.init_params(..., master=True)``)."""
    if len(tree["stages"]) != cfg.num_stages:
        raise ValueError(f"tree has {len(tree['stages'])} stages, config {cfg.num_stages}")
    return _convert(tree, "", device, master)
