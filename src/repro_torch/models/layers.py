"""Shared primitive layers: norms, activations, embeddings, RoPE, FFNs.

The counterpart of ``repro.models.layers``.  Parameters are nested dicts of
tensors.  For serving, weight matrices are stored in bf16 once at load (the
JAX package keeps f32 masters and casts them to bf16 at every matmul, which
gives the same products); training keeps f32 masters as the reference does
(``models.model.init_params(..., master=True)``), and every matmul casts.
Norm scales, norm biases and QKV biases stay f32 and are cast where the
reference casts them.  The reference's ``loop_map`` / ``loop_scan`` are
plain Python loops here (they exist there for XLA's cost analysis).
"""
from __future__ import annotations

import math
from typing import Any

import torch

Params = dict[str, Any]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with bf16 operands, f32 accumulation and a bf16 result.

    On the card this is one bf16 GEMM.  On the CPU the product is taken in
    f32 over the bf16 operands and rounded once, which is what the JAX
    package's CPU backend computes; torch's CPU bf16 GEMM blocks its sums
    differently and would round a few elements the other way.
    """
    x = x.to(torch.bfloat16)
    w = w.to(torch.bfloat16)
    if x.is_cuda:
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float()).to(torch.bfloat16)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two bf16 operands with a bf16 result, rounded as
    ``matmul`` rounds: one bf16 product on the card, the f32 product rounded
    once on the CPU (the reference's ``jnp.einsum`` on bf16 operands)."""
    if a.is_cuda:
        return torch.einsum(eq, a, b)
    return torch.einsum(eq, a.float(), b.float()).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Norms (f32 inside, result in the input dtype)
# ---------------------------------------------------------------------------


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * params["scale"]
    return y.to(dtype)


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y.to(dtype)


def apply_norm(kind: str, params: Params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


class _Logistic(torch.autograd.Function):
    """``1 / (1 + exp(-x))`` op for op in the input dtype, as
    ``lax.logistic`` lowers, with its derivative rule ``g * (s * (1 - s))``
    (autograd through the three ops would round a bf16 gradient at other
    places than the reference does)."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


class _Tanh(torch.autograd.Function):
    """``torch.tanh`` with ``lax.tanh``'s derivative rule ``(g + g * t) *
    (1 - t)`` (torch's is ``g * (1 - t * t)``, which rounds otherwise in
    bf16)."""

    @staticmethod
    def forward(ctx, x):
        t = torch.tanh(x)
        ctx.save_for_backward(t)
        return t

    @staticmethod
    def backward(ctx, g):
        (t,) = ctx.saved_tensors
        return (g + g * t) * (1.0 - t)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * logistic(x)``, the logistic ``1 / (1 + exp(-x))`` op for op in
    the input dtype, as ``jax.nn.silu`` lowers: each step rounds to bf16 on
    a bf16 input."""
    return x * _Logistic.apply(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it, ``logaddexp(x,
    0)``: exact for large x, where ``torch.nn.functional.softplus`` turns
    linear above its threshold of 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``-softplus(-x)``, ``jax.nn.log_sigmoid``'s form."""
    return -softplus(-x)


_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, ``jax.nn.gelu``'s default (``F.gelu(x,
    approximate="tanh")``'s function; torch's default is the exact erf
    form): ``x * 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))`` op for op
    in the input dtype, as ``jax.nn.gelu`` lowers: both constants are
    rounded to the input dtype first (JAX's weak typing) and each step
    rounds to bf16 on a bf16 input, as the reference's does (the fused
    ``F.gelu`` rounds once and parts from it on ~40% of bf16 values)."""
    c, a = (torch.tensor(v, dtype=x.dtype, device=x.device) for v in (_SQRT_2_OVER_PI, 0.044715))
    return x * (0.5 * (1.0 + _Tanh.apply(c * (x + a * (x**3)))))


_ACTS = {"silu": silu, "gelu": gelu}


def activation(name: str):
    if name not in _ACTS:
        raise NotImplementedError(f"activation {name!r} is not ported yet")
    return _ACTS[name]


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for even head dims (f32, [head_dim // 2])."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(
    x: torch.Tensor,  # [..., seq, heads, head_dim]
    positions: torch.Tensor,  # [..., seq]
    theta: float = 1e4,
) -> torch.Tensor:
    """Standard rotate-half RoPE over the last dim, position-indexed, f32 inside."""
    head_dim = x.shape[-1]
    inv = rope_frequencies(head_dim, theta, device=x.device)
    angles = positions[..., :, None].float() * inv  # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings and feed-forward blocks
# ---------------------------------------------------------------------------


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Row lookup in the bf16 table (the reference casts, then indexes)."""
    return params["embed"].to(torch.bfloat16)[tokens]


def glu_ffn_init(dense, d: int, d_ff: int) -> Params:
    """A GLU FFN's weights; ``dense(shape)`` makes one (``models.model``)."""
    return {"w_gate": dense((d, d_ff)), "w_up": dense((d, d_ff)), "w_down": dense((d_ff, d))}


def glu_ffn(params: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated FFN (SwiGLU et al.): down(act(gate(x)) * up(x))."""
    g = activation(act)(matmul(x, params["w_gate"]))
    u = matmul(x, params["w_up"])
    return matmul(g * u, params["w_down"])


def mlp_ffn_init(dense, d: int, d_ff: int) -> Params:
    """The two-matmul MLP FFN's weights (``dense`` as in ``glu_ffn_init``)."""
    return {"w_up": dense((d, d_ff)), "w_down": dense((d_ff, d))}


def mlp_ffn(params: Params, x: torch.Tensor, act: str = "gelu") -> torch.Tensor:
    """Classic FFN: down(act(up(x)))."""
    return matmul(activation(act)(matmul(x, params["w_up"])), params["w_down"])
