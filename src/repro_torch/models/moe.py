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
    Under a mesh see ``_moe_sharded``.
    """
    if layers.is_dtensor(x):
        return _moe_sharded(params, x, dims)
    B, S, d = x.shape
    T = B * S
    C = capacity(T, dims)
    xf = x.reshape(T, d)
    gates, idx, probs_full = router_probs(matmul(xf, params["router"]).float(), dims)
    f_e, p_e = _load(idx, probs_full, dims)
    flat_e, slot = dispatch_slots(idx, C, dims.num_experts)
    expert_in = _dispatch(xf, flat_e, slot, C, dims)
    out = _combine(_experts(params["experts"], expert_in, dims), flat_e, slot, gates, dims)
    if "shared" in params:
        out = out + layers.glu_ffn(params["shared"], xf, dims.act)
    return out.reshape(B, S, d), dims.num_experts * torch.sum(f_e * p_e)


def _load(idx: torch.Tensor, probs_full: torch.Tensor, dims: MoeDims):
    """(f_e, P_e): the share of the choices, and the mean router
    probability, of each expert over these tokens."""
    ones = torch.zeros(probs_full.shape, dtype=torch.float32, device=idx.device)
    ones.scatter_(1, idx, 1.0)  # a token's k experts are distinct
    return ones.mean(dim=0) / dims.top_k, probs_full.mean(dim=0)


def _dispatch(xf: torch.Tensor, flat_e: torch.Tensor, slot: torch.Tensor, C: int,
              dims: MoeDims) -> torch.Tensor:
    """The per-expert buffers ``[E, C, d]``: each kept (expert, slot) cell
    receives its token, the rest are zeros."""
    T, d = xf.shape
    token_of_choice = torch.arange(T, device=xf.device).repeat_interleave(dims.top_k)
    buf = torch.zeros((dims.num_experts, C + 1, d), dtype=xf.dtype, device=xf.device)
    # slot C collects the dropped choices and is cut off
    buf[flat_e, slot] = xf[token_of_choice]
    return buf[:, :C]


def _experts(we: Params, expert_in: torch.Tensor, dims: MoeDims) -> torch.Tensor:
    """The expert FFNs batched over experts, in the hidden dtype."""
    act = layers.activation(dims.act)
    dt = expert_in.dtype
    g = act(einsum("ecd,edf->ecf", expert_in, we["w_gate"].to(dt)))
    u = einsum("ecd,edf->ecf", expert_in, we["w_up"].to(dt))
    return einsum("ecf,efd->ecd", g * u, we["w_down"].to(dt))


def _combine(expert_out: torch.Tensor, flat_e: torch.Tensor, slot: torch.Tensor,
             gates: torch.Tensor, dims: MoeDims) -> torch.Tensor:
    """Each token's k expert outputs gathered back and weighted by its
    gates: ``[T, d]`` (a dropped choice, at slot C, reads zeros)."""
    E, C, d = expert_out.shape
    T, k = gates.shape
    padded = torch.cat([expert_out, expert_out.new_zeros((E, 1, d))], dim=1)
    picked = padded[flat_e, slot]  # [T*k, d]
    weighted = picked * gates.reshape(T * k)[:, None].to(picked.dtype)
    # the k-sum as ``jnp.sum`` computes it on bf16: in f32, rounded once
    return weighted.reshape(T, k, d).float().sum(dim=1).to(weighted.dtype)


def _moe_sharded(params: Params, x: torch.Tensor, dims: MoeDims):
    """``moe_forward`` on DTensors, with the reference's meaning: the
    capacity C is that of the whole batch and a choice is dropped where its
    rank among its expert's choices, over the whole batch's token order,
    reaches C, so the same choices are dropped as in one call over every row.

    Each device routes its own batch rows (x's batch split kept, the rest of
    x gathered; the router gathered whole) and counts its choices per
    expert.  The counts are all-gathered over the batch axes: the choices of
    the devices before it in the batch order give each device its ranks'
    offsets, so it knows which of its own choices are kept.  It writes those
    into its own buffers ``[E, C_dev, d]``, C_dev the most choices any device
    keeps for one expert (the balanced share ``capacity(T_dev)`` on meta
    tensors, which hold no routing), and the buffers are the batch-split
    parts of one ``[E, n * C_dev, d]``.  The experts run on that, their
    hidden dim split over "model" as ``param_specs`` lays them out (each
    device gathers its FSDP part, never an expert whole), the down
    product's partial sums reduced over "model"; each device combines its
    own tokens.  The load-balance loss is exact: each device's share of f_e
    and P_e is summed over the batch axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    mesh = x.device_mesh
    rows = [isinstance(p, Shard) and p.dim == 0 for p in x.placements]
    row_split = [Shard(0) if r else Replicate() for r in rows]
    row_parts = [Partial() if r else Replicate() for r in rows]

    x_l = x.redistribute(mesh, row_split).to_local(grad_placements=row_split)
    B_l, S, d = x_l.shape
    T_l, E, k = B_l * S, dims.num_experts, dims.top_k
    C = capacity(x.shape[0] * S, dims)
    router = params["router"].redistribute(mesh, [Replicate()] * mesh.ndim)
    xf = x_l.reshape(T_l, d)
    # the router's gradient from this device's rows is a part of the whole
    logits = matmul(xf, router.to_local(grad_placements=row_parts)).float()
    gates, idx, probs_full = router_probs(logits, dims)
    f_l, p_l = _load(idx, probs_full, dims)

    # every device's choices per expert, in the batch order; the choices of
    # the devices before this one offset its ranks
    flat_e, rank = dispatch_slots(idx, T_l * k, E)  # ranks among this device's choices
    count = torch.zeros(E, dtype=torch.int64, device=x_l.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    counts = DTensor.from_local(count[None], mesh, row_split, run_check=False).full_tensor()
    before = torch.cumsum(counts, 0) - counts
    offset = distribute_tensor(before, mesh, row_split, src_data_rank=None).to_local()[0]
    if x_l.is_meta:
        c_dev = min(C, capacity(T_l, dims))
    else:
        c_dev = int(torch.clamp(torch.minimum(counts, C - before), min=0).max())
    slot = torch.where(offset[flat_e] + rank < C, rank, c_dev)
    buf = _dispatch(xf, flat_e, slot, c_dev, dims)

    split_c = [Shard(1) if r else Replicate() for r in rows]
    expert_in = DTensor.from_local(buf, mesh, split_c, run_check=False)
    we = {name: _expert_weight(t.to(x.dtype), rows, 1 if name == "w_down" else 2)
          for name, t in params["experts"].items()}
    expert_out = _experts(we, expert_in, dims).redistribute(mesh, split_c)
    out_l = _combine(expert_out.to_local(grad_placements=split_c), flat_e, slot, gates, dims)

    share = B_l / x.shape[0]  # the rows' share of the batch
    f_e = DTensor.from_local(f_l * share, mesh, row_parts, run_check=False)
    p_e = DTensor.from_local(p_l * share, mesh, row_parts, run_check=False)
    aux = dims.num_experts * torch.sum(f_e * p_e)
    out = DTensor.from_local(out_l.reshape(B_l, S, d), mesh, row_split, run_check=False)
    if "shared" in params:
        out = out + layers.glu_ffn(params["shared"], x, dims.act)
    return out, aux


def _expert_weight(w: torch.Tensor, rows: list[bool], hidden: int) -> torch.Tensor:
    """An expert stack laid out for ``_moe_sharded``'s products: its hidden
    dim (``hidden``) kept split along the mesh axes that split it and do not
    split the batch, every other dim gathered (an FSDP split, at its use)."""
    from torch.distributed.tensor import Replicate, Shard

    target = [p if isinstance(p, Shard) and p.dim == hidden and not r else Replicate()
              for p, r in zip(w.placements, rows)]
    return w if target == list(w.placements) else w.redistribute(w.device_mesh, target)


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
