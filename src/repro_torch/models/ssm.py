"""State-space and recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM, sLSTM).

The counterpart of ``repro.models.ssm``, op for op in plain torch: the
reference has no kernel for these blocks.  Its ``lax.scan`` over chunks
(``loop_scan``) is a Python loop here over the operands unbound once into
their chunks, and sLSTM's scan over time is ``layers.scan`` (a loop, which
the dry run counts without running every step).  Dtypes follow the
reference's: the projections are bf16 products, the scans and gates f32,
and mLSTM's queries f32 (the reference divides the bf16 product by a NumPy
scalar, which promotes it to f32), so mLSTM's cell output stays f32 until
the down-projection.

  * Mamba2 runs the chunked SSD algorithm (quadratic within a chunk, a scan
    across chunk states); the token-by-token recurrence serves decode.
  * mLSTM runs the same chunkwise decomposition with log-space
    stabilization; ``mlstm_step`` is its decode recurrence.
  * sLSTM is sequential by construction (h_{t-1} feeds the gates).

Both chunked scans keep ``_pick_chunk``'s choice, so a sequence whose length
has no divisor near the requested chunk (a prime above it) runs chunks of 1.

The mLSTM memory is read transposed, as in the reference
(``repro/models/ssm.py:372`` and ``:435``): the state stores ``C[p, n] =
v_p k_n`` but is read as ``sum_p q_p C[p, n]``, which contracts q with the
value index, while the intra-chunk part contracts q with the key.  So
``mlstm_chunked`` agrees with ``mlstm_step`` only inside its first chunk, and
its result depends on the chunk size.  The port keeps this, since it is held
to the reference (ROADMAP queue 3).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import layers
from repro_torch.models.layers import Params, matmul
from repro_torch.sharding import local_map, local_shard, split_dims


def _pick_chunk(seq_len: int, chunk: int) -> int:
    if seq_len % chunk == 0:
        return chunk
    # largest divisor of seq_len not exceeding requested chunk
    for c in range(min(chunk, seq_len), 0, -1):
        if seq_len % c == 0:
            return c
    return seq_len


def segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums: out[..., t, s] = sum_{u=s+1..t} a[..., u].

    Entries with s > t are -inf (used as log-decays).
    """
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.tensor(-torch.inf, dtype=diff.dtype, device=a.device))


def _repeat(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``jnp.repeat``: each entry along ``dim`` ``n`` times in a row."""
    return x if n == 1 else torch.repeat_interleave(x, n, dim=dim)


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (+ decode cache)
# ---------------------------------------------------------------------------


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: [B,S,C], w: [K,C] depthwise, left-padded causal; adds in x's dtype.
    Under a mesh it runs on each device's rows and channels."""
    if layers.is_dtensor(x):
        return local_map(causal_conv1d, (x, w, b), (("b", None, "c"), (None, "c"), ("c",)),
                         (("b", None, "c"),))
    K, S = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + S, :] * w[i][None, None, :].to(x.dtype)
    return out + b[None, None, :].to(x.dtype)


def conv_step(x_t: torch.Tensor, conv_cache: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """One decode step: x_t [B,C]; conv_cache [B,K-1,C] holds prior inputs.
    Under a mesh it runs on each device's rows and channels of the cache."""
    if layers.is_dtensor(conv_cache):
        return local_map(lambda c, x, w_, b_: conv_step(x, c, w_, b_), (conv_cache, x_t, w, b),
                         (("b", None, "c"), ("b", "c"), (None, "c"), ("c",)),
                         (("b", "c"), ("b", None, "c")))
    window = torch.cat([conv_cache, x_t[:, None, :]], dim=1)  # [B,K,C]
    out = layers.einsum("bkc,kc->bc", window, w.to(x_t.dtype)) + b.to(x_t.dtype)
    return out, window[:, 1:]


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MambaDims:
    d_model: int
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def in_proj_dim(self) -> int:
        # [z, x, B, C, dt]
        return 2 * self.d_inner + 2 * self.n_groups * self.d_state + self.num_heads


def mamba_init(dims: MambaDims, dense, normal, const, norm) -> Params:
    """One Mamba2 block's parameters, each stacked over the stage's periods
    (``models.model``): ``dense(shape)`` a bf16 weight and ``normal(shape)``
    an f32 one, both truncated normal with the fan-in of ``shape[0]``;
    ``const(t)`` an f32 constant; ``norm(d)`` an RMSNorm scale."""
    H = dims.num_heads
    return {
        "in_proj": dense((dims.d_model, dims.in_proj_dim)),
        "conv_w": dense((dims.conv_kernel, dims.conv_dim)),
        "conv_b": const(torch.zeros((dims.conv_dim,))),
        "a_log": const(torch.log(torch.linspace(1.0, 16.0, H))),  # A = -exp(a_log)
        "d_skip": const(torch.ones((H,))),
        "dt_bias": const(torch.log(torch.expm1(torch.full((H,), 0.01)))),  # softplus^-1(0.01)
        "norm": norm(dims.d_inner),
        "out_proj": dense((dims.d_inner, dims.d_model)),
    }


def _mamba_split(params: Params, x: torch.Tensor, dims: MambaDims):
    proj = matmul(x, params["in_proj"])
    di = dims.d_inner
    z = proj[..., :di]
    xbc = proj[..., di:di + dims.conv_dim]
    dt = proj[..., di + dims.conv_dim:]
    return z, xbc, dt


def ssd_chunked(
    x: torch.Tensor,  # [B,S,H,P]
    a: torch.Tensor,  # [B,S,H]  log-decay per step (= dt * A, negative)
    b: torch.Tensor,  # [B,S,G,N]
    c: torch.Tensor,  # [B,S,G,N]
    chunk: int,
    initial_state: torch.Tensor | None = None,  # [B,H,P,N]
):
    """Chunked SSD scan (Mamba2).  Returns (y [B,S,H,P], final_state)."""
    if layers.is_dtensor(x):  # each device's rows and heads (``sharding.local_map``)
        if initial_state is not None:
            raise NotImplementedError("ssd_chunked under a mesh starts from a zero state")
        h = "h" if b.shape[2] == 1 else None  # heads stay split over one shared group only
        return local_map(lambda *t: ssd_chunked(*t, chunk), (x, a, b, c),
                         (("b", None, h, None), ("b", None, h), ("b", None, None, None),
                          ("b", None, None, None)), (("b", None, h, None), ("b", h, None, None)))
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    Q = _pick_chunk(S, chunk)
    nC = S // Q
    hpg = H // G  # heads per group

    xr = x.reshape(B, nC, Q, H, P)
    ar = a.reshape(B, nC, Q, H).float()
    br = b.reshape(B, nC, Q, G, N)
    cr = c.reshape(B, nC, Q, G, N)

    a_cum = torch.cumsum(ar, dim=2)  # [B,nC,Q,H]

    # ---- intra-chunk (quadratic) -------------------------------------------
    L = torch.exp(segsum(ar.permute(0, 1, 3, 2)))  # [B,nC,H,Q,Q]
    cb = torch.einsum("bcqgn,bcsgn->bcgqs", cr.float(), br.float())
    cb = _repeat(cb, hpg, 2)  # [B,nC,H,Q,S] group -> heads
    scores = (cb * L).to(x.dtype)
    y_diag = layers.einsum("bchqs,bcshp->bcqhp", scores, xr)

    # ---- chunk boundary states ---------------------------------------------
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # [B,nC,Q,H]
    # the reference's einsum sums over the group index too (one group here)
    bx = torch.einsum("bcqgn,bcqh,bcqhp->bchpn", br.float(), decay_to_end, xr.float())

    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # [B,nC,H] total decay of chunk

    h = (initial_state.float() if initial_state is not None
         else torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device))
    h_prevs = []
    for decay_c, bx_c in zip(chunk_decay.unbind(1), bx.unbind(1)):
        h_prevs.append(h)  # the state entering the chunk, then its update
        h = h * decay_c[:, :, None, None] + bx_c
    h_prevs = torch.stack(h_prevs, dim=1)  # [B,nC,H,P,N]

    # ---- inter-chunk output ------------------------------------------------
    state_decay = torch.exp(a_cum)  # decay from chunk start to step q
    c_full = _repeat(cr.float(), hpg, 3)  # [B,nC,Q,H,N]
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", c_full, h_prevs, state_decay)

    y = (y_diag.float() + y_off).reshape(B, S, H, P)
    return y.to(x.dtype), h


def ssd_step(
    x_t: torch.Tensor,  # [B,H,P]
    a_t: torch.Tensor,  # [B,H]
    b_t: torch.Tensor,  # [B,G,N]
    c_t: torch.Tensor,  # [B,G,N]
    state: torch.Tensor,  # [B,H,P,N] f32
):
    """Single-token SSD recurrence (decode).  Under a mesh it runs on each
    device's rows and heads of the state (``sharding.local_map``)."""
    if layers.is_dtensor(state):
        h = "h" if b_t.shape[1] == 1 else None  # heads stay split over one shared group only
        return local_map(lambda st, *a: ssd_step(*a, st), (state, x_t, a_t, b_t, c_t),
                         (("b", h, None, None), ("b", h, None), ("b", h), ("b", None, None),
                          ("b", None, None)), (("b", h, None), ("b", h, None, None)))
    hpg = x_t.shape[1] // b_t.shape[1]
    b_full = _repeat(b_t, hpg, 1).float()  # [B,H,N]
    c_full = _repeat(c_t, hpg, 1).float()
    decay = torch.exp(a_t.float())[..., None, None]
    new_state = state * decay + torch.einsum("bhp,bhn->bhpn", x_t.float(), b_full)
    y = torch.einsum("bhpn,bhn->bhp", new_state, c_full)
    return y.to(x_t.dtype), new_state


def mamba_forward(
    params: Params,
    x: torch.Tensor,  # [B,S,d]
    dims: MambaDims,
    initial_state: torch.Tensor | None = None,
    return_state: bool = False,
):
    B, S, _ = x.shape
    H, P, N, G = dims.num_heads, dims.head_dim, dims.d_state, dims.n_groups
    z, xbc, dt_raw = _mamba_split(params, x, dims)
    xbc = layers.silu(causal_conv1d(xbc, params["conv_w"], params["conv_b"]))
    xs = xbc[..., :dims.d_inner].reshape(B, S, H, P)
    b = xbc[..., dims.d_inner:dims.d_inner + G * N].reshape(B, S, G, N)
    c = xbc[..., dims.d_inner + G * N:].reshape(B, S, G, N)

    dt = layers.softplus(dt_raw.float() + params["dt_bias"])  # [B,S,H]
    a = -torch.exp(params["a_log"])[None, None, :] * dt  # log decay, negative

    y, state = ssd_chunked(xs * dt[..., None].to(xs.dtype), a, b, c, dims.chunk, initial_state)
    y = y + xs * params["d_skip"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, dims.d_inner)
    y = layers.rmsnorm(params["norm"], y * layers.silu(z))
    out = matmul(y, params["out_proj"])
    if return_state:
        return out, state
    return out


def make_mamba_cache(batch: int, dims: MambaDims, device="cuda") -> Params:
    return {
        "conv": torch.zeros((batch, dims.conv_kernel - 1, dims.conv_dim), dtype=torch.bfloat16,
                            device=device),
        "ssd": torch.zeros((batch, dims.num_heads, dims.head_dim, dims.d_state),
                           dtype=torch.float32, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def mamba_decode(params: Params, x: torch.Tensor, cache: Params, dims: MambaDims):
    """x: [B,1,d] -> (out [B,1,d], new cache leaves)."""
    B = x.shape[0]
    H, P, N, G = dims.num_heads, dims.head_dim, dims.d_state, dims.n_groups
    z, xbc, dt_raw = _mamba_split(params, x[:, 0], dims)
    xbc, conv_new = conv_step(xbc, cache["conv"], params["conv_w"], params["conv_b"])
    xbc = layers.silu(xbc)
    xs = xbc[..., :dims.d_inner].reshape(B, H, P)
    b = xbc[..., dims.d_inner:dims.d_inner + G * N].reshape(B, G, N)
    c = xbc[..., dims.d_inner + G * N:].reshape(B, G, N)
    dt = layers.softplus(dt_raw.float() + params["dt_bias"])  # [B,H]
    a = -torch.exp(params["a_log"])[None, :] * dt
    y, ssd_new = ssd_step(xs * dt[..., None].to(xs.dtype), a, b, c, cache["ssd"])
    y = y + xs * params["d_skip"][None, :, None].to(y.dtype)
    y = layers.rmsnorm(params["norm"], y.reshape(B, dims.d_inner) * layers.silu(z))
    out = matmul(y, params["out_proj"])[:, None, :]
    return out, {"conv": conv_new, "ssd": ssd_new, "pos": cache["pos"] + 1}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell), chunkwise-parallel
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class XlstmDims:
    d_model: int
    num_heads: int
    expand: int = 2  # mLSTM inner expansion
    conv_kernel: int = 4
    chunk: int = 256
    slstm_proj_factor: float = 4.0 / 3.0

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def m_head_dim(self) -> int:
        assert self.d_inner % self.num_heads == 0
        return self.d_inner // self.num_heads

    @property
    def s_head_dim(self) -> int:
        assert self.d_model % self.num_heads == 0
        return self.d_model // self.num_heads

    @property
    def slstm_ff(self) -> int:
        f = int(self.d_model * self.slstm_proj_factor)
        return ((f + 63) // 64) * 64


def mlstm_init(dims: XlstmDims, dense, normal, const, norm) -> Params:
    """One mLSTM block's parameters (the callables as in ``mamba_init``)."""
    di, H = dims.d_inner, dims.num_heads
    return {
        "up_proj": dense((dims.d_model, 2 * di)),  # [x | z-gate]
        "conv_w": dense((dims.conv_kernel, di)),
        "conv_b": const(torch.zeros((di,))),
        "w_q": dense((di, di)),
        "w_k": dense((di, di)),
        "w_v": dense((di, di)),
        "w_if": dense((di, 2 * H)),  # input & forget gate logits
        "if_bias": const(torch.cat([torch.zeros((H,)), 3.0 * torch.ones((H,))])),
        "norm_h": norm(di),
        "down_proj": dense((di, dims.d_model)),
    }


def _query_scale(P: int) -> float:
    """1 / sqrt(P) as the reference divides by it: an f32 scalar."""
    return float(np.float32(np.sqrt(P)))


def mlstm_chunked(
    q: torch.Tensor,  # [B,S,H,P] (already scaled by 1/sqrt(P))
    k: torch.Tensor,  # [B,S,H,P]
    v: torch.Tensor,  # [B,S,H,P]
    i_gate: torch.Tensor,  # [B,S,H]  raw input-gate logits (exp gate)
    f_gate: torch.Tensor,  # [B,S,H]  raw forget-gate logits (sigmoid in log space)
    chunk: int,
    initial: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
):
    """Stabilized chunkwise mLSTM.  Returns (h [B,S,H,P], (C, n, m) final).

    State convention: stored (C_hat, n_hat) are the true values scaled by
    exp(-m); m is the running log-stabilizer per (B, H).  Under a mesh it
    runs on each device's rows and heads (``sharding.local_map``).
    """
    if layers.is_dtensor(q):
        if initial is not None:
            raise NotImplementedError("mlstm_chunked under a mesh starts from a zero state")
        bshp, bsh = ("b", None, "h", None), ("b", None, "h")
        h, C, n, m = local_map(
            lambda *a: _flat_state(mlstm_chunked(*a, chunk)), (q, k, v, i_gate, f_gate),
            (bshp, bshp, bshp, bsh, bsh),
            (bshp, ("b", "h", None, None), ("b", "h", None), ("b", "h")))
        return h, (C, n, m)
    B, S, H, P = q.shape
    Q = _pick_chunk(S, chunk)
    nC = S // Q
    dev = q.device

    qr = q.reshape(B, nC, Q, H, P)
    kr = k.reshape(B, nC, Q, H, P)
    vr = v.reshape(B, nC, Q, H, P)
    ir = i_gate.reshape(B, nC, Q, H).float()
    lf = layers.log_sigmoid(f_gate.reshape(B, nC, Q, H).float())

    F = torch.cumsum(lf, dim=2)  # [B,nC,Q,H] inclusive cumsum of log-forgets
    F_total = F[:, :, -1, :]  # [B,nC,H]

    # log-weights of intra-chunk source s for target t:  F_t - F_s + i_s
    D = (F[:, :, :, None, :] - F[:, :, None, :, :]) + ir[:, :, None, :, :]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    D = torch.where(tri[None, None, :, :, None], D, torch.tensor(-torch.inf, device=dev))
    intra_max = torch.amax(D, dim=3)  # [B,nC,Q,H]

    if initial is None:
        C_hat = torch.zeros((B, H, P, P), dtype=torch.float32, device=dev)
        n_hat = torch.zeros((B, H, P), dtype=torch.float32, device=dev)
        m = torch.full((B, H), -1e30, dtype=torch.float32, device=dev)  # empty state: weight 0
    else:
        C_hat, n_hat, m = initial

    hs = []
    # each operand unbound into its chunks once: the backward stacks the
    # chunks' gradients once
    chunks = zip(*(t.unbind(1) for t in (qr, kr, vr, D, intra_max, F, F_total, ir)))
    for qc, kc, vc, Dc, imaxc, Fc, Ftotc, irc in chunks:
        qc, kc, vc = qc.float(), kc.float(), vc.float()
        # new stabilizer per step: max(intra max, F_t + m_prev)
        m_t = torch.maximum(imaxc, Fc + m[:, None, :])  # [B,Q,H]
        w_intra = torch.exp(Dc - m_t[:, :, None, :])  # [B,t,s,H]
        scores = torch.einsum("bthp,bshp->btsh", qc, kc)
        sw = scores * w_intra
        num_intra = torch.einsum("btsh,bshp->bthp", sw, vc)
        den_intra = torch.sum(sw, dim=2)  # [B,t,H]

        # the state read contracts q with C's first (value) index, as the
        # reference does (its ssm.py:372; see the module docstring)
        w_state = torch.exp(Fc + m[:, None, :] - m_t)  # [B,Q,H]
        num_state = torch.einsum("bthp,bhpn->bthn", qc, C_hat)
        num_state = num_state * w_state[..., None]
        den_state = torch.einsum("bthp,bhp->bth", qc, n_hat) * w_state

        num = num_intra + num_state
        den = den_intra + den_state
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None])

        # ---- end-of-chunk state update ---------------------------------------
        lw_src = Ftotc[:, None, :] - Fc + irc  # [B,Q,H] log-weight of source s
        m_new = torch.maximum(Ftotc + m, torch.amax(lw_src, dim=1))  # [B,H]
        w_src = torch.exp(lw_src - m_new[:, None, :])  # [B,Q,H]
        C_hat = C_hat * torch.exp(Ftotc + m - m_new)[..., None, None] + torch.einsum(
            "bshp,bsh,bshn->bhpn", vc, w_src, kc
        )
        n_hat = n_hat * torch.exp(Ftotc + m - m_new)[..., None] + torch.einsum(
            "bsh,bshp->bhp", w_src, kc
        )
        m = m_new

    h = torch.stack(hs, dim=1).reshape(B, S, H, P)
    return h.to(q.dtype), (C_hat, n_hat, m)


def _flat_state(out):
    """``(h, (C, n, m))`` as ``(h, C, n, m)``."""
    h, (C, n, m) = out
    return h, C, n, m


def mlstm_step(
    q: torch.Tensor,  # [B,H,P] scaled
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,  # [B,H]
    f_gate: torch.Tensor,  # [B,H]
    state: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
):
    if layers.is_dtensor(state[0]):  # each device's rows and heads of the state
        bhp, bh = ("b", "h", None), ("b", "h")
        h, C, n, m = local_map(
            lambda C, n, m, *a: _flat_state(mlstm_step(*a, (C, n, m))),
            (*state, q, k, v, i_gate, f_gate),
            (("b", "h", None, None), bhp, bh, bhp, bhp, bhp, bh, bh),
            (bhp, ("b", "h", None, None), bhp, bh))
        return h, (C, n, m)
    C_hat, n_hat, m = state
    lf = layers.log_sigmoid(f_gate.float())
    i = i_gate.float()
    m_new = torch.maximum(lf + m, i)
    f_w = torch.exp(lf + m - m_new)
    i_w = torch.exp(i - m_new)
    kf = k.float()
    vf = v.float()
    # C[p, n] = v_p k_n, read below as sum_p q_p C[p, n] (the reference's
    # ssm.py:431 and :435; see the module docstring)
    C_new = C_hat * f_w[..., None, None] + i_w[..., None, None] * torch.einsum(
        "bhp,bhn->bhpn", vf, kf
    )
    n_new = n_hat * f_w[..., None] + i_w[..., None] * kf
    qf = q.float()
    num = torch.einsum("bhp,bhpn->bhn", qf, C_new)
    den = torch.einsum("bhp,bhp->bh", qf, n_new)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    return h.to(q.dtype), (C_new, n_new, m_new)


def _mlstm_qkv_gates(params: Params, xi: torch.Tensor, conv_out: torch.Tensor, shape, P: int):
    """q (f32, scaled), k, v (bf16) and the f32 gate logits of an mLSTM block."""
    H = shape[-2]
    q = layers.split_last(matmul(conv_out, params["w_q"]), H, P).float() / _query_scale(P)
    k = layers.split_last(matmul(conv_out, params["w_k"]), H, P)
    v = layers.split_last(matmul(xi, params["w_v"]), H, P)
    gates = matmul(xi, params["w_if"]).float() + params["if_bias"]
    i_gate, f_gate = torch.chunk(gates, 2, dim=-1)
    return q, k, v, i_gate, f_gate


def mlstm_forward(
    params: Params,
    x: torch.Tensor,
    dims: XlstmDims,
    initial: tuple | None = None,
    return_state: bool = False,
):
    B, S, _ = x.shape
    H, P = dims.num_heads, dims.m_head_dim
    up = matmul(x, params["up_proj"])
    xi, z = torch.chunk(up, 2, dim=-1)
    conv_out = layers.silu(causal_conv1d(xi, params["conv_w"], params["conv_b"]))
    q, k, v, i_gate, f_gate = _mlstm_qkv_gates(params, xi, conv_out, (B, S, H, P), P)
    h, state = mlstm_chunked(q, k, v, i_gate, f_gate, dims.chunk, initial)
    h = layers.merge_last(h)  # [B,S,d_inner]
    h = layers.rmsnorm(params["norm_h"], h) * layers.silu(z)
    out = matmul(h, params["down_proj"])
    if return_state:
        return out, state
    return out


def make_mlstm_cache(batch: int, dims: XlstmDims, device="cuda") -> Params:
    H, P = dims.num_heads, dims.m_head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, dims.conv_kernel - 1, dims.d_inner), dtype=torch.bfloat16,
                            device=device),
        "C": torch.zeros((batch, H, P, P), **f32),
        "n": torch.zeros((batch, H, P), **f32),
        "m": torch.full((batch, H), -1e30, **f32),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def mlstm_decode(params: Params, x: torch.Tensor, cache: Params, dims: XlstmDims):
    B = x.shape[0]
    H, P = dims.num_heads, dims.m_head_dim
    up = matmul(x[:, 0], params["up_proj"])
    xi, z = torch.chunk(up, 2, dim=-1)
    conv_out, conv_new = conv_step(xi, cache["conv"], params["conv_w"], params["conv_b"])
    conv_out = layers.silu(conv_out)
    q, k, v, i_gate, f_gate = _mlstm_qkv_gates(params, xi, conv_out, (B, H, P), P)
    h, (C, n, m) = mlstm_step(q, k, v, i_gate, f_gate, (cache["C"], cache["n"], cache["m"]))
    h = layers.rmsnorm(params["norm_h"], h.reshape(B, dims.d_inner)) * layers.silu(z)
    out = matmul(h, params["down_proj"])[:, None, :]
    return out, {"conv": conv_new, "C": C, "n": n, "m": m, "pos": cache["pos"] + 1}


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory cell), sequential by construction
# ---------------------------------------------------------------------------


def slstm_init(dims: XlstmDims, dense, normal, const, norm) -> Params:
    """One sLSTM block's parameters (the callables as in ``mamba_init``)."""
    d, H, P = dims.d_model, dims.num_heads, dims.s_head_dim
    return {
        "w_gates": dense((d, 4 * d)),  # z, i, f, o pre-activations
        "r_gates": normal((H, P, 4 * P)),  # block-diagonal recurrent, f32
        "gate_bias": const(torch.zeros((4 * d,))),
        "norm_h": norm(d),
        "ffn": layers.glu_ffn_init(dense, d, dims.slstm_ff),
    }


def slstm_cell(
    w_x: torch.Tensor,  # [B, 4d] input pre-activations for this step
    r_gates: torch.Tensor,  # [H, P, 4P]
    gate_bias: torch.Tensor,
    state: tuple,  # (c, n, h, m) each [B,H,P]
    H: int,
    P: int,
):
    if layers.is_dtensor(w_x):  # one step under a mesh (``_slstm_mesh_scan``)
        state, hs = _slstm_mesh_scan(w_x[:, None], r_gates, gate_bias, state, H, P)
        return state, hs[:, 0]
    c, n, h, m = state
    rec = torch.einsum("bhp,hpq->bhq", h, r_gates.to(h.dtype))  # [B,H,4P]
    pre = layers.split_last(w_x, H, 4 * P).float() + rec.float()
    pre = pre + layers.split_last(gate_bias, H, 4 * P)[None]
    return _slstm_gates(pre, (c, n, m))


def _slstm_gates(pre: torch.Tensor, state: tuple):
    """The cell's update from its f32 pre-activations ``pre [B,H,4P]`` (z, i,
    f, o) and ``(c, n, m)``: ``((c, n, h, m), h)``."""
    c, n, m = state
    z_p, i_p, f_p, o_p = torch.chunk(pre, 4, dim=-1)  # each [B,H,P]
    z = torch.tanh(z_p)
    o = torch.sigmoid(o_p)
    lf = layers.log_sigmoid(f_p)
    m_new = torch.maximum(lf + m, i_p)
    i_w = torch.exp(i_p - m_new)
    f_w = torch.exp(lf + m - m_new)
    c_new = f_w * c + i_w * z
    n_new = f_w * n + i_w
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, h_new, m_new), h_new


# -- sLSTM under a mesh: the step's activations move, the weight stays -------


def _wait(t: torch.Tensor) -> torch.Tensor:
    return torch.ops._c10d_functional.wait_tensor(t)


def _all_gather0(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every device of ``group`` along dim 0."""
    return _wait(torch.ops._c10d_functional.all_gather_into_tensor(
        x.contiguous(), group.size(), group.group_name))


def _reduce_scatter0(x: torch.Tensor, group) -> torch.Tensor:
    """This device's part of dim 0 of ``x`` summed over ``group``."""
    return _wait(torch.ops._c10d_functional.reduce_scatter_tensor(
        x.contiguous(), "sum", group.size(), group.group_name))


def _all_to_all0(x: torch.Tensor, group) -> torch.Tensor:
    """Part ``j`` of dim 0 of ``x`` to device ``j`` of ``group``; the parts
    received, in device order along dim 0."""
    split = [x.shape[0] // group.size()] * group.size()
    return _wait(torch.ops._c10d_functional.all_to_all_single(
        x.contiguous(), split, split, group.group_name))


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``."""
    return _wait(torch.ops._c10d_functional.all_reduce(x.contiguous(), "sum", group.group_name))


class _RecSplitHeads(torch.autograd.Function):
    """``rec [B, H_l, 4P]`` of this device's heads, where ``group`` splits the
    heads (``h [B, H_l, P]``) and ``r_gates``' columns (``r [H, P, c]``, this
    device's ``c = 4P / m``) alike: every head's ``h`` gathered, this
    device's columns of every head, then one all-to-all that brings each
    head's columns to its device.  It saves its own heads and gathers them
    again for its backward, which sends each device its columns' gradient,
    computes ``r``'s and sums ``h``'s back to its heads' devices."""

    @staticmethod
    def forward(ctx, h, r, group):
        ctx.group = group
        ctx.save_for_backward(h, r)
        m, (B, Hl, _), c = group.size(), h.shape, r.shape[-1]
        rec = torch.einsum("hbp,hpq->hbq", _all_gather0(h.transpose(0, 1), group), r)
        out = _all_to_all0(rec, group).view(m, Hl, B, c)  # [source's columns, head, row, q]
        return out.permute(2, 1, 0, 3).reshape(B, Hl, m * c)

    @staticmethod
    def backward(ctx, g):
        h, r = ctx.saved_tensors
        group, m, (B, Hl, _), c = ctx.group, ctx.group.size(), h.shape, r.shape[-1]
        g = g.reshape(B, Hl, m, c).permute(2, 1, 0, 3).reshape(m * Hl, B, c)
        g = _all_to_all0(g, group)  # [H, B, c]: this device's columns of every head
        d_r = d_h = None
        if ctx.needs_input_grad[1]:
            d_r = torch.einsum("hbp,hbq->hpq", _all_gather0(h.transpose(0, 1), group), g)
        if ctx.needs_input_grad[0]:
            d_h = _reduce_scatter0(torch.einsum("hbq,hpq->hbp", g, r), group).transpose(0, 1)
        return d_h, d_r, None


class _WholeColumns(torch.autograd.Function):
    """``x [..., k]``, this device's ``k`` columns, as ``[..., m k]``, every
    device's, by one all-gather over ``group`` (of ``m``).  Every device of
    the group then runs the same cell on the same state, so the backward
    keeps this device's columns of the gradient (each holds all of it)."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.m, ctx.rank = group.size(), rank
        return _all_gather0(x, group).unflatten(0, (ctx.m, -1)).movedim(0, -2).flatten(-2)

    @staticmethod
    def backward(ctx, g):
        return g.unflatten(-1, (ctx.m, -1)).select(-2, ctx.rank).contiguous(), None, None


class _SummedGrad(torch.autograd.Function):
    """The identity, its gradient summed over ``group``: ``h`` meets each
    device's own columns of ``r_gates``, so each device holds a part of
    its gradient."""

    @staticmethod
    def forward(ctx, h, group):
        ctx.group = group
        return h.view_as(h)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _slstm_mesh_scan(w_x, r_gates, gate_bias, initial: tuple, H: int, P: int):
    """sLSTM's time loop under a mesh: ``w_x [B, S, 4d]`` a DTensor, the
    state ``(c, n, h, m)`` DTensors or plain tensors taken as replicated.
    Returns ``((c, n, h, m), hs [B, S, H, P])`` as DTensors.

    ``r_gates``, ``gate_bias`` and ``w_x`` stay in the layouts
    ``param_specs`` and the projection give them: ``r_gates``' 4P columns
    split over the mesh dim that splits them ("model"), ``w_x``'s and
    ``gate_bias``' 4d columns alike, which is by heads.  Each step moves its
    activations instead, the plan of the reference's compiled program.
    Where that dim divides the heads, each device holds its heads' state:
    ``h`` is gathered, each device computes its columns of every head's
    ``rec`` and one all-to-all brings each head's columns to its device.
    Where it does not (a "model" axis wider than the heads), the state is
    whole on every device of that dim, which all-gather the step's columns
    of ``w_x`` and of ``rec``.  The inputs are laid out once, before the
    loop, and the loop runs on local tensors: nothing in it re-lays out a
    tensor, and ``r_gates``' gradient is summed over the steps on each
    device and reduced once, after the loop."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = w_x.device_mesh
    cols = split_dims(r_gates, 2)
    i = cols[0] if cols else None
    m = mesh.size(i) if i is not None else 1
    heads = i is not None and H % m == 0  # the state's heads split over dim i
    rows = split_dims(w_x, 0)
    Hl = H // m if heads else H

    def layout(row: int, head: int, split: bool = heads) -> list:
        return [Shard(row) if j in rows else Shard(head) if split and j == i else Replicate()
                for j in range(mesh.ndim)]

    def summed(target: list) -> list:  # a weight's gradient from this device's rows
        return [Partial() if j in rows else p for j, p in enumerate(target)]

    r_layout = [Shard(2) if j == i else Replicate() for j in range(mesh.ndim)]
    g_layout = [Shard(0) if heads and j == i else Replicate() for j in range(mesh.ndim)]
    xs = local_shard(w_x, mesh, layout(0, 2, i is not None))
    r = local_shard(r_gates, mesh, r_layout, summed(r_layout)).float()
    g = local_shard(gate_bias, mesh, g_layout, summed(g_layout))
    carry = tuple(local_shard(t, mesh, layout(0, 1)) for t in initial)
    if i is not None:
        group, rank = mesh.get_group(i), mesh.get_local_rank(i)

    def step(state, w_t):
        c, n, h, m_ = state
        if heads:
            rec = _RecSplitHeads.apply(h, r, group)
        elif i is not None:
            w_t = _WholeColumns.apply(w_t, group, rank)
            rec = torch.einsum("bhp,hpq->bhq", _SummedGrad.apply(h, group), r)
            rec = _WholeColumns.apply(rec, group, rank)
        else:
            rec = torch.einsum("bhp,hpq->bhq", h, r)
        pre = layers.split_last(w_t, Hl, 4 * P).float() + rec
        pre = pre + layers.split_last(g, Hl, 4 * P)[None]
        return _slstm_gates(pre, (c, n, m_))

    state, hs = layers.scan(step, carry, xs, params=(r, g))
    state = tuple(DTensor.from_local(t, mesh, layout(0, 1), run_check=False) for t in state)
    return state, DTensor.from_local(hs, mesh, layout(0, 2), run_check=False)


def slstm_forward(
    params: Params,
    x: torch.Tensor,
    dims: XlstmDims,
    initial: tuple | None = None,
    return_state: bool = False,
):
    B, S, d = x.shape
    H, P = dims.num_heads, dims.s_head_dim
    w_x = matmul(x, params["w_gates"])  # [B,S,4d]

    if initial is None:
        zeros = torch.zeros((B, H, P), dtype=torch.float32, device=x.device)
        initial = (zeros, zeros, zeros, torch.full((B, H, P), -1e30, dtype=torch.float32,
                                                   device=x.device))
    r_gates, gate_bias = params["r_gates"], params["gate_bias"]
    if layers.is_dtensor(w_x):
        state, hs = _slstm_mesh_scan(w_x, r_gates, gate_bias, initial, H, P)
    else:
        state, hs = layers.scan(
            lambda state, w_t: slstm_cell(w_t, r_gates, gate_bias, state, H, P),
            initial, w_x, params=(r_gates, gate_bias))
    h = layers.merge_last(hs).to(x.dtype)  # [B,S,d]
    h = layers.rmsnorm(params["norm_h"], h)
    out = h + layers.glu_ffn(params["ffn"], h)
    if return_state:
        return out, state
    return out


def make_slstm_cache(batch: int, dims: XlstmDims, device="cuda") -> Params:
    H, P = dims.num_heads, dims.s_head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, H, P), **f32),
        "n": torch.zeros((batch, H, P), **f32),
        "h": torch.zeros((batch, H, P), **f32),
        "m": torch.full((batch, H, P), -1e30, **f32),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def slstm_decode(params: Params, x: torch.Tensor, cache: Params, dims: XlstmDims):
    B = x.shape[0]
    H, P = dims.num_heads, dims.s_head_dim
    w_x = matmul(x[:, 0], params["w_gates"])
    state = (cache["c"], cache["n"], cache["h"], cache["m"])
    (c, n, h_s, m), h = slstm_cell(w_x, params["r_gates"], params["gate_bias"], state, H, P)
    hh = layers.rmsnorm(params["norm_h"], h.reshape(B, -1).to(x.dtype))
    out = hh + layers.glu_ffn(params["ffn"], hh)
    return out[:, None, :], {"c": c, "n": n, "h": h_s, "m": m, "pos": cache["pos"] + 1}
