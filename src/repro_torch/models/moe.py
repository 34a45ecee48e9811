"""Mixture-of-Experts with capacity-based scatter dispatch (GShard-style) —
the counterpart of ``repro.models.moe``.

Tokens are dispatched into per-expert capacity buffers ``[E, C, d]`` and the
experts run as three batched products over E, so the work is proportional to
``top_k * capacity_factor``, as in the reference.  A choice's place in its
expert's buffer is its rank among the choices of that expert, counted over
the ``(token, k)`` choices in row-major order (an exclusive prefix sum);
choices ranked at or past the capacity C are dropped to a sacrificial slot C,
which the combine reads as zeros.  The capacity depends on the number of
tokens in the call, so padded batch rows take capacity as real ones do, in
both packages.

The reference computes these products with ``einsum`` outside any Pallas
kernel, so here they are plain torch on every device (``layers.einsum``
rounds as the reference's CPU backend does).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import layers
from repro_torch.models.layers import Params, einsum, matmul


@dataclasses.dataclass(frozen=True)
class MoeDims:
    d_model: int
    d_ff_expert: int
    num_experts: int
    top_k: int
    num_shared: int = 0
    d_ff_shared: int = 0  # total shared-expert hidden dim (0 => num_shared * d_ff_expert)
    capacity_factor: float = 1.25
    act: str = "silu"
    # "softmax_topk": softmax over all experts then take top-k (DeepSeek)
    # "topk_softmax": take top-k logits then softmax over them (Mixtral)
    router_norm: str = "topk_softmax"

    @property
    def shared_ff(self) -> int:
        if self.num_shared == 0:
            return 0
        return self.d_ff_shared or self.num_shared * self.d_ff_expert


def moe_init(dims: MoeDims, dense) -> Params:
    """One MoE FFN's parameters; ``dense(shape)`` makes one bf16 weight
    stacked over the stage's periods (``models.model._dense``), with the
    truncated normal's fan-in taken from the first dimension of ``shape``.
    That is the reference's law, also for the expert stacks ``[E, d, f]``,
    whose fan-in is E there.
    """
    E, d, f = dims.num_experts, dims.d_model, dims.d_ff_expert
    p: Params = {
        "router": dense((d, E)),
        "experts": {
            "w_gate": dense((E, d, f)),
            "w_up": dense((E, d, f)),
            "w_down": dense((E, f, d)),
        },
    }
    if dims.num_shared > 0:
        p["shared"] = layers.glu_ffn_init(dense, d, dims.shared_ff)
    return p


def _topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last dim, largest first, ties to the
    lower index (``jax.lax.top_k``'s order; ``torch.topk`` keeps no order
    among equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_probs(logits: torch.Tensor, dims: MoeDims):
    """Return (gates [T,k], expert_idx [T,k], probs_full [T,E]) from f32 logits."""
    probs_full = torch.softmax(logits, dim=-1)
    if dims.router_norm == "softmax_topk":
        gates, idx = _topk(probs_full, dims.top_k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    else:
        top_logits, idx = _topk(logits, dims.top_k)
        gates = torch.softmax(top_logits, dim=-1)
    return gates, idx, probs_full


def capacity(num_tokens: int, dims: MoeDims) -> int:
    c = int(np.ceil(num_tokens * dims.top_k * dims.capacity_factor / dims.num_experts))
    return max(c, dims.top_k)


def dispatch_slots(idx: torch.Tensor, C: int, E: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(expert [T*k], slot [T*k]) of every (token, k) choice: the slot is the
    choice's rank among its expert's choices in row-major order, or C (the
    sacrificial slot) where that rank reaches the capacity."""
    flat_e = idx.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat_e, E).to(torch.int32)  # [T*k, E]
    ranks_all = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot  # exclusive
    rank = torch.gather(ranks_all, 1, flat_e[:, None])[:, 0]
    return flat_e, torch.where(rank >= C, C, rank)


def moe_forward(params: Params, x: torch.Tensor, dims: MoeDims):
    """x: [B, S, d]  ->  (out [B, S, d], aux_loss scalar).

    aux_loss is the switch-style load-balance loss E * sum_e f_e * P_e.
    """
    B, S, d = x.shape
    T = B * S
    E, k = dims.num_experts, dims.top_k
    C = capacity(T, dims)
    xf = x.reshape(T, d)

    logits = matmul(xf, params["router"]).float()  # [T, E]
    gates, idx, probs_full = router_probs(logits, dims)

    # ---- aux load-balance loss -------------------------------------------
    ones = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    ones.scatter_(1, idx, 1.0)  # a token's k experts are distinct
    f_e = ones.mean(dim=0) / k
    p_e = probs_full.mean(dim=0)
    aux = E * torch.sum(f_e * p_e)

    # ---- dispatch: scatter tokens into per-expert buffers ----------------
    flat_e, slot = dispatch_slots(idx, C, E)
    token_of_choice = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = torch.zeros((E, C + 1, d), dtype=xf.dtype, device=x.device)
    # each kept (expert, slot) cell receives one token; slot C collects the
    # dropped ones and is cut off
    buf[flat_e, slot] = xf[token_of_choice]
    expert_in = buf[:, :C]  # [E, C, d]

    # ---- expert FFN (batched over experts), in the hidden dtype ----------
    we = params["experts"]
    act = layers.activation(dims.act)
    dt = expert_in.dtype
    g = act(einsum("ecd,edf->ecf", expert_in, we["w_gate"].to(dt)))
    u = einsum("ecd,edf->ecf", expert_in, we["w_up"].to(dt))
    expert_out = einsum("ecf,efd->ecd", g * u, we["w_down"].to(dt))

    # ---- combine: gather back and weight by gates --------------------------
    padded = torch.cat([expert_out, expert_out.new_zeros((E, 1, d))], dim=1)  # slot C reads zeros
    picked = padded[flat_e, slot]  # [T*k, d]
    weighted = picked * gates.reshape(T * k)[:, None].to(picked.dtype)
    # the k-sum as ``jnp.sum`` computes it on bf16: in f32, rounded once
    out = weighted.reshape(T, k, d).float().sum(dim=1).to(weighted.dtype)

    if "shared" in params:
        out = out + layers.glu_ffn(params["shared"], xf, dims.act)

    return out.reshape(B, S, d), aux


def moe_active_params(dims: MoeDims) -> int:
    """Parameters touched per token (for 6*N_active*D roofline accounting)."""
    per_expert = 3 * dims.d_model * dims.d_ff_expert
    routed = dims.top_k * per_expert
    shared = 3 * dims.d_model * dims.shared_ff
    router = dims.d_model * dims.num_experts
    return routed + shared + router


def moe_total_params(dims: MoeDims) -> int:
    per_expert = 3 * dims.d_model * dims.d_ff_expert
    shared = 3 * dims.d_model * dims.shared_ff
    router = dims.d_model * dims.num_experts
    return dims.num_experts * per_expert + shared + router
