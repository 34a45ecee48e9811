"""Shared primitive layers: norms, activations, embeddings, RoPE, FFNs.

The counterpart of ``repro.models.layers``.  Parameters are nested dicts of
tensors.  For serving, weight matrices are stored in bf16 once at load (the
JAX package keeps f32 masters and casts them to bf16 at every matmul, which
gives the same products); training keeps f32 masters as the reference does
(``models.model.init_params(..., master=True)``), and every matmul casts.
Norm scales, norm biases and QKV biases stay f32 and are cast where the
reference casts them.  The reference's ``loop_map`` / ``loop_scan`` are
plain Python loops here (they exist there for XLA's cost analysis);
``scan``, the counterpart of its ``jax.lax.scan`` over time, is a loop too,
which the dry run counts without running every step (``set_scan``).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.sharding import get_mesh, is_dtensor, split_dims

Params = dict[str, Any]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with bf16 operands, f32 accumulation and a bf16 result.

    On the card this is one bf16 GEMM.  On the CPU the product is taken in
    f32 over the bf16 operands and rounded once, which is what the JAX
    package's CPU backend computes; torch's CPU bf16 GEMM blocks its sums
    differently and would round a few elements the other way.  Under a
    mesh an activation split along its sequence is gathered first
    (``gather_inner``), as is an FSDP weight's contracted dim
    (``gather_contraction``).  A row-parallel weight, its contracted dim
    split over the tensor-parallel axis (``w_o``, ``w_down``), stays split
    where that moves fewer bytes (``row_parallel``: decode's one-token rows),
    and each device multiplies its split of ``x``'s last dim; the partial
    sums are all-reduced (on the CPU added in f32 before the rounding).
    """
    if is_dtensor(x):
        x = gather_inner(x.to(torch.bfloat16))
        x, w = row_parallel(x, gather_contraction(w.to(torch.bfloat16)))
        return _GatherInnerGrad.apply(_matmul(x, w))
    return _matmul(x.to(torch.bfloat16), w.to(torch.bfloat16))


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cpu":  # the card, or the dry run's meta tensors
        return reduce_partial(torch.matmul(x, w))
    return reduce_partial(torch.matmul(_f32(x), _f32(w))).to(torch.bfloat16)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32; a DTensor's gradient has its partial sums added in f32
    before it is rounded back to ``x``'s dtype, once, as without a mesh."""
    return _F32.apply(x) if is_dtensor(x) else x.float()


class _F32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.float()

    @staticmethod
    def backward(ctx, g):
        return reduce_partial(g).to(ctx.dtype)


class _GatherInnerGrad(torch.autograd.Function):
    """Identity on a product's DTensor output whose gradient is gathered
    along its inner dims (``gather_inner``), as its input was: a gradient
    split along the sequence (by a sequence-parallel residual downstream)
    would reach the product's backward, which flattens batch and sequence."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return gather_inner(g)


def gather_inner(x: torch.Tensor) -> torch.Tensor:
    """A DTensor activation gathered along every dim but its first and its
    last (the sequence of a sequence-parallel residual, Megatron's
    all-gather before a column-parallel product); anything else as it is."""
    if not is_dtensor(x) or x.ndim < 3:
        return x
    from torch.distributed.tensor import Replicate, Shard

    target = [Replicate() if isinstance(p, Shard) and 0 < p.dim < x.ndim - 1 else p
              for p in x.placements]
    return x if target == list(x.placements) else x.redistribute(x.device_mesh, target)


def split_last(x: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """``x [..., n * size]`` as ``[..., n, size]`` (heads out of a
    projection).  A DTensor whose last dim is split over more devices than
    ``n`` divides among is gathered along it first."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        last = [i for i, p in enumerate(x.placements)
                if isinstance(p, Shard) and p.dim == x.ndim - 1]
        if n % math.prod(x.device_mesh.size(i) for i in last):
            target = [Replicate() if i in last else p for i, p in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, target)
    return x.reshape(*x.shape[:-1], n, size)


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x [..., n, size]`` as ``[..., n * size]`` (heads into a projection's
    input).  For a DTensor the gradient coming back is gathered along its
    last dim where its split does not fall on head boundaries (the reshape's
    backward could not split it into heads)."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    return _MergeLast.apply(x)


class _MergeLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.heads = x.shape[-2]
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate, Shard

        last = [i for i, p in enumerate(g.placements)
                if isinstance(p, Shard) and p.dim == g.ndim - 1]
        if ctx.heads % math.prod(g.device_mesh.size(i) for i in last):
            g = g.redistribute(g.device_mesh, [Replicate() if i in last else p
                                               for i, p in enumerate(g.placements)])
        return g.reshape(*g.shape[:-1], ctx.heads, g.shape[-1] // ctx.heads)


def gather_contraction(w: torch.Tensor) -> torch.Tensor:
    """A DTensor weight gathered along its contracted (second to last) dim
    where a mesh dim other than the tensor-parallel axis splits it: an
    FSDP-split weight is all-gathered at its use, so the activations keep
    their batch split; a split over the tensor-parallel axis is left to
    ``row_parallel``; anything else as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    rules = get_mesh()
    tp = "model" if rules is None else rules.tp_axis
    gather = [i for i in split_dims(w, -2) if w.device_mesh.mesh_dim_names[i] != tp]
    if not gather:
        return w
    return w.redistribute(w.device_mesh, [Replicate() if i in gather else p
                                          for i, p in enumerate(w.placements)])


def row_parallel(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, w) laid out for ``x @ w`` where the tensor-parallel axis splits
    ``w``'s contracted dim.  The product then either stays split, ``x``'s
    last dim split alike (a local slice where it is replicated) and the
    partial sums all-reduced, or gathers ``w`` along that dim, whichever
    moves fewer bytes a device: the all-reduce of this device's output
    (twice its bytes, in f32 on the CPU) against the weight gathered.
    Decode's one-token rows keep it split; a prefill or training batch
    gathers the weight, as before."""
    dims = split_dims(w, -2)
    if not dims:
        return x, w
    from torch.distributed.tensor import Replicate, Shard

    xl = x.to_local()
    rows = xl.numel() // max(1, xl.shape[-1])
    out_bytes = rows * w.shape[-1] * (4 if xl.device.type == "cpu" else 2)
    w_bytes = w.to_local().numel() * math.prod(w.device_mesh.size(i) for i in dims) * 2
    if 2 * out_bytes > w_bytes:
        return x, w.redistribute(w.device_mesh, [Replicate() if i in dims else p
                                                 for i, p in enumerate(w.placements)])
    last = x.ndim - 1
    target = [Shard(last) if i in dims else
              (Replicate() if isinstance(p, Shard) and p.dim == last else p)
              for i, p in enumerate(x.placements)]
    if target != list(x.placements):
        x = x.redistribute(x.device_mesh, target)
    return x, w


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with partial sums (a contraction split over a mesh axis)
    reduced to replicated along those axes; anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate

    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    target = [Replicate() if isinstance(p, Partial) else p for p in x.placements]
    return x.redistribute(x.device_mesh, target)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of two bf16 operands with a bf16 result, rounded as
    ``matmul`` rounds: one bf16 product on the card, the f32 product rounded
    once on the CPU (the reference's ``jnp.einsum`` on bf16 operands)."""
    if a.device.type != "cpu":  # the card, or the dry run's meta tensors
        return torch.einsum(eq, a, b)
    return reduce_partial(torch.einsum(eq, _f32(a), _f32(b))).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Scan over time
# ---------------------------------------------------------------------------


def loop_scan(body, carry: tuple, xs: torch.Tensor, params: tuple = ()):
    """``scan`` as a Python loop, one ``body`` call a step."""
    ys = []
    for t in range(xs.shape[1]):
        carry, y = body(carry, xs[:, t])
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


_scan_impl = loop_scan


def scan(body, carry: tuple, xs: torch.Tensor, params: tuple = ()):
    """``jax.lax.scan`` over dim 1 of ``xs``: ``body(carry, x_t) -> (carry,
    y_t)`` for each step in turn, ``carry`` a tuple of tensors; returns the
    last carry and the ``y_t`` stacked along dim 1.  ``params`` are the
    tensors ``body`` reads besides its arguments.  This is ``loop_scan``
    unless a dry run has installed its count (``set_scan``), which runs the
    body once or twice and returns ``params``' gradients itself."""
    return _scan_impl(body, carry, xs, tuple(params))


def set_scan(impl=None):
    """Make ``impl(body, carry, xs, params)`` what ``scan`` runs (None:
    ``loop_scan``); returns the one it replaces."""
    global _scan_impl
    old, _scan_impl = _scan_impl, impl or loop_scan
    return old


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
    """Row lookup in the bf16 table (the reference casts, then indexes).
    A DTensor table is looked up where it lies (``_embed_sharded``)."""
    if is_dtensor(params["embed"]):
        return _embed_sharded(params["embed"], tokens)
    return params["embed"].to(torch.bfloat16)[tokens]


def _embed_sharded(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The vocab-parallel lookup: each device looks up the tokens that fall
    in its own rows of the table (its vocab split kept, its width gathered)
    and zeros for the others; the rows' sum over the vocab split is the
    lookup (a partial sum the caller's layout reduces).  The tokens keep
    their batch split on the other mesh dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    mesh = table.device_mesh
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    w = table.redistribute(mesh, [Shard(0) if v else Replicate() for v in vocab])
    if not is_dtensor(tokens):
        tokens = distribute_tensor(tokens, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)
    rows = [not v and isinstance(p, Shard) and p.dim == 0
            for v, p in zip(vocab, tokens.placements)]
    t = tokens.redistribute(mesh, [Shard(0) if r else Replicate() for r in rows])
    # the table's gradient from this device's rows is a part of the whole
    # along the mesh dims that split the rows
    w_l = w.to_local(grad_placements=[Partial() if r else p for r, p in zip(rows, w.placements)])
    w_l, t_l = w_l.to(torch.bfloat16), t.to_local()
    start, coord = 0, mesh.get_coordinate()
    for i, v in enumerate(vocab):  # the first row of this device's split
        if v:
            start = start * mesh.size(i) + coord[i]
    start *= w_l.shape[0]
    local = t_l.long() - start
    inside = (local >= 0) & (local < w_l.shape[0])
    out = torch.where(inside[..., None], w_l[local.clamp(0, w_l.shape[0] - 1)], 0.0)
    pl = [Shard(0) if r else (Partial() if v else Replicate()) for r, v in zip(rows, vocab)]
    return DTensor.from_local(out.to(torch.bfloat16), mesh, pl, run_check=False)


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
