"""Checks of the port's training gradients against the JAX package's, block by block,
for every registry config reduced: each block of every stage gets the JAX
forward's own input (op by op, ``jax.disable_jit``) and a seeded cotangent,
and the port's autograd through ``models.model._block_apply(..., "train")``
(its MoE aux loss with cotangent 1) is held to ``jax.vjp`` of the
reference's: the input's cotangent and every leaf of the block norm-wise at
2^-7.  The embedding's gradient is held the same way.  Block by block, as
the card's gates are: through a whole stack the random weights carry the
frameworks' last-bit gaps far past any fixed tolerance (PERF.md).

An MoE block is held half by half (attention, then the MoE), so that the
router's gap stays in the router.

Held looser (``LOOSER``): leaves the reference casts to bf16 and
broadcasts (QKV biases, conv taps, the MoE router through its bf16 gates):
the JAX CPU backend sums their bf16 cotangent row after row in bf16, the
port in f32 (``tests/test_torch_train_loss.py`` shows it on one bias).

Held to a witness instead of the reference (``WITNESSED``): Mamba's
``d_skip`` (cast to bf16 and broadcast as above, over 2048 products of
random sign, so the reference's bf16 sum parts from the exact one by up to
~10%) and ``dt_bias`` (an f32 sum over the sequence with deep cancellation,
where every program's bf16 cotangents part by ~1%).  The witness is the
reference's own gradient built in forward mode (``_forward_witness``), with
no transposed broadcast and its contraction in f64.  Each block's port
gradient must lie within the leaf's bound of the witness, and over all the
blocks the port must be nearer the witness than the reference is (measured
on reduced zamba2: ``d_skip`` the port <= 0.93%, the reference <= 10.3%;
``dt_bias`` the port <= 1.7%, the reference <= 3.3%; the witness carries
its own bf16 tangents, so neither bound is 2^-7).

The whole model's gradient (``check_whole_grads``) is held to the
reference's own spread: the reference run op by op and the same reference
jitted are two programs of the same math, and through a stack they part
past 2^-7 on some leaves of every config.  The port's gradient, a third
program, must lie within that gap of the op-by-op one: the whole tree
norm-wise no farther than the jitted reference's, and each leaf within
twice the jitted reference's gap on that leaf (the triangle inequality's
bound, were the port as near the jitted program as that is to the op-by-op
one) or 2^-7, whichever is larger.
"""
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.models import attention as tattention
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe

from repro_torch.training.train_step import value_and_grad

from torch_train_common import (
    GRAD_RTOL, master_params, named_leaves, rel_err, torch_leaves_like, train_batch,
)

# leaf name -> norm-wise bound, with the measured worst gap at this size
LOOSER = {
    "b_q": 2.0**-5, "b_k": 2.0**-5, "b_v": 2.0**-5,  # <= 1.5e-2
    "conv_w": 2.0**-5, "conv_b": 2.0**-5,  # <= 1.2e-2
    "router": 2.0**-5,  # <= 1.1e-2
}
# leaf name -> norm-wise bound against the forward-mode witness, with the
# port's measured worst gap from it at this size
WITNESSED = {
    "d_skip": 2.0**-6,  # 9.3e-3
    "dt_bias": 2.0**-5,  # 1.7e-2
}
# the most a whole-model leaf may part from the op-by-op reference, however
# far the jitted reference parts from it: a zeroed gradient parts by 1
WHOLE_LEAF_CAP = 0.5


def _halves(lib, attention, layers, moe, kind, cfg, pos):
    """A ``"moe_attn"`` block as its two residual halves, each ``(params,
    x) -> (x', aux)``: attention (``norm1``, ``attn``) and the MoE
    (``norm2``, ``moe``), as ``_block_apply`` composes them; other kinds
    whole.  Held half by half, the attention half gets the reference's own
    cotangent, so the MoE gates' bf16 sum (``LOOSER``) does not reach it."""
    if kind != "moe_attn":
        return [(None, lambda p, x: lib._block_apply(kind, p, x, cfg, pos, "train")[::2])]

    def attn_half(p, x):
        h = layers.apply_norm(cfg.norm, p["norm1"], x)
        if cfg.mla is not None:
            out = attention.mla_forward(p["attn"], h, cfg.mla, pos, cfg.q_chunk)
        else:
            kw = {"train": True} if lib is tmodel else {}
            out = attention.gqa_forward(p["attn"], h, cfg.attn_dims(), pos, cfg.q_chunk, **kw)
        return x + out, (None if lib is tmodel else jnp.zeros((), jnp.float32))

    def moe_half(p, x):
        out, aux = moe.moe_forward(p["moe"], layers.apply_norm(cfg.norm, p["norm2"], x), cfg.moe)
        return x + out, aux

    return [(("norm1", "attn"), attn_half), (("norm2", "moe"), moe_half)]


def _check(name, want, got):
    err = rel_err(want, got)
    assert err <= LOOSER.get(name.split("/")[-1], GRAD_RTOL), f"{name}: {err:.3g}"


def _forward_witness(jf, p, x, ct, k: int) -> np.ndarray:
    """The gradient of ``sum(ct * y) + aux`` with respect to leaf ``k`` of
    ``p`` (JAX's order), built in forward mode: one ``jax.jvp`` of the
    reference along each element of the leaf, its output tangent contracted
    with the cotangent in f64.  No broadcast is transposed, so no bf16
    cotangent is summed row after row."""
    leaves, spec = jax.tree.flatten(p)
    leaf = leaves[k]
    basis = jnp.eye(leaf.size, dtype=leaf.dtype).reshape((leaf.size,) + leaf.shape)
    zeros = [jnp.zeros_like(a) for a in leaves]

    def directional(t):
        tangent = jax.tree.unflatten(spec, zeros[:k] + [t] + zeros[k + 1:])
        return jax.jvp(jf, (p, x), (tangent, jnp.zeros_like(x)))[1]

    y_dot, aux_dot = jax.vmap(directional)(basis)
    y_dot = np.asarray(y_dot.astype(jnp.float32), np.float64)
    ct = np.asarray(jnp.asarray(ct, x.dtype).astype(jnp.float32), np.float64)  # as the vjp gets it
    w = y_dot.reshape(leaf.size, -1) @ ct.ravel() + np.asarray(aux_dot, np.float64)
    return w.reshape(leaf.shape)


def _as_f64(g) -> np.ndarray:
    if isinstance(g, torch.Tensor):
        return g.detach().double().numpy().ravel()
    return np.asarray(jnp.asarray(g).astype(jnp.float32), np.float64).ravel()


def _witness_err(witness: np.ndarray, got: np.ndarray) -> float:
    return float(np.linalg.norm(witness - got) / np.linalg.norm(witness))


def check_block_grads(arch: str) -> None:
    jp, tp, jcfg, tcfg = master_params(arch)
    jb, tb = train_batch(jcfg)
    rng = np.random.default_rng(1)
    S = jb["labels"].shape[1]
    pos, tpos = jnp.arange(S), torch.arange(S, dtype=torch.int32)
    n_blocks = 0
    witnessed = {name: [] for name in WITNESSED}  # (witness, port, reference) per block
    with jax.disable_jit():
        x, vjp = jax.vjp(lambda p: jmodel._embed_inputs(p, jb, jcfg), jp)
        if jcfg.frontend == "tokens":
            ct = rng.standard_normal(x.shape).astype(np.float32)
            (jg,) = vjp(jnp.asarray(ct, x.dtype))
            te = tp["embed"]["embed"].clone().requires_grad_(True)
            ty = tmodel.embed_inputs({"embed": {"embed": te}}, tb, tcfg)
            (tg,) = torch.autograd.grad(ty, [te], torch.from_numpy(ct).to(ty.dtype))
            _check("embed", jg["embed"]["embed"], tg)
        for si, stage in enumerate(jp["stages"]):
            n_periods = jax.tree.leaves(stage)[0].shape[0]
            for i in range(n_periods):
                for j, kind in enumerate(jcfg.period):
                    p_all = jax.tree.map(lambda a: a[i], stage["blocks"][j])
                    t_all = tmodel._period(tp["stages"][si]["blocks"][j], i)
                    jparts = _halves(jmodel, jattention, jlayers, jmoe, kind, jcfg, pos)
                    tparts = _halves(tmodel, tattention, tlayers, tmoe, kind, tcfg, tpos)
                    for (keys, jf), (_, tf) in zip(jparts, tparts):
                        p = p_all if keys is None else {k: p_all[k] for k in keys}
                        tparams = t_all if keys is None else {k: t_all[k] for k in keys}
                        ct = rng.standard_normal(x.shape).astype(np.float32)
                        (y, aux), vjp = jax.vjp(jf, p, x)
                        jgp, jgx = vjp((jnp.asarray(ct, y.dtype), jnp.ones((), jnp.float32)))

                        leaves = [t.clone().requires_grad_(True)
                                  for t in torch_leaves_like(tparams)]
                        it = iter(leaves)
                        # the JAX block's structure with the port's leaves in order
                        tblock = jax.tree.map(lambda _: next(it), p)
                        tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()
                        tx.requires_grad_(True)
                        out, taux = tf(tblock, tx)
                        outs, cts = [out], [torch.from_numpy(ct).to(out.dtype)]
                        if taux is not None:
                            outs.append(taux)
                            cts.append(torch.ones(()))
                        grads = torch.autograd.grad(outs, [tx] + leaves, cts, allow_unused=True)
                        where = f"stage {si + 1} period {i} {kind} {keys or ''}"
                        _check(f"{where} x", jgx, grads[0])
                        for n, ((name, want), got) in enumerate(zip(named_leaves(jgp), grads[1:])):
                            assert got is not None, f"{where} {name}: no gradient"
                            leaf = name.split("/")[-1]
                            if leaf in WITNESSED:
                                w = _forward_witness(jf, p, x, ct, n).ravel()
                                witnessed[leaf].append((w, _as_f64(got), _as_f64(want)))
                                err = _witness_err(w, _as_f64(got))
                                assert err <= WITNESSED[leaf], f"{where} {name}: {err:.3g} from the witness"
                            else:
                                _check(f"{where} {name}", want, got)
                        x = y
                    n_blocks += 1
    assert n_blocks == sum(jcfg.stage_periods()) * len(jcfg.period)
    for leaf, rows in witnessed.items():
        if rows:
            w, port, ref = (np.concatenate(r) for r in zip(*rows))
            e_port, e_ref = _witness_err(w, port), _witness_err(w, ref)
            print(f"{arch} {leaf} over {len(rows)} blocks, from the forward-mode witness: the port "
                  f"{e_port:.3g}, the reference {e_ref:.3g}")
            assert e_port < e_ref, f"{leaf}: the port {e_port:.3g}, the reference {e_ref:.3g}"


def _tree_rel_err(want: list, got: list) -> float:
    """``rel_err`` of two leaf lists taken as one vector each."""
    a = np.concatenate([np.asarray(jnp.asarray(w).astype(jnp.float32), np.float64).ravel()
                        for w in want])
    b = np.concatenate([g.detach().double().numpy().ravel() for g in got])
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@functools.lru_cache(maxsize=None)
def _whole_grads(arch: str):
    """(leaf names, the op-by-op reference's gradients, the jitted
    reference's, the port's) of the whole ``loss_fn``, in JAX's leaf order."""
    jp, tp, jcfg, tcfg = master_params(arch)
    jb, tb = train_batch(jcfg)
    grad = jax.grad(lambda p: jmodel.loss_fn(p, jb, jcfg)[0])
    jitted = jax.tree.leaves(jax.jit(grad)(jp))
    with jax.disable_jit():
        named = named_leaves(grad(jp))
    _, _, tgrads = value_and_grad(lambda p, b: tmodel.loss_fn(p, b, tcfg), tp, tb)
    got = torch_leaves_like(tgrads)
    as_torch = [torch.from_numpy(np.array(j.astype(jnp.float32))) for j in jitted]
    assert len(got) == len(named) == len(as_torch)
    return [n for n, _ in named], [w for _, w in named], as_torch, got


def whole_grads_own_gaps(arch: str) -> list[float]:
    """Each leaf's jitted-vs-op-by-op gap in the reference."""
    _, want, jitted, _ = _whole_grads(arch)
    return [rel_err(w, j) for w, j in zip(want, jitted)]


def check_whole_grads(arch: str, zeroed: int | None = None) -> None:
    """The gradient of the whole ``loss_fn`` against the reference's run op
    by op, held to the reference's own jitted-vs-op-by-op gap (the module
    docstring); ``zeroed`` plants a fault, the port's gradient of that leaf
    set to zero."""
    names, want, jitted, got = _whole_grads(arch)
    if zeroed is not None:
        got = list(got)
        got[zeroed] = torch.zeros_like(got[zeroed])
    own = _tree_rel_err(want, jitted)
    port = _tree_rel_err(want, got)
    own_leaf = whole_grads_own_gaps(arch)
    port_leaf = [rel_err(w, g) for w, g in zip(want, got)]
    print(f"{arch}: whole tree, the port {port:.3g}, the jitted reference {own:.3g}; worst leaf, "
          f"the port {max(port_leaf):.3g}, the jitted reference {max(own_leaf):.3g}")
    assert port <= own, f"whole tree: port {port:.3g}, the jitted reference {own:.3g}"
    for name, o, e in zip(names, own_leaf, port_leaf):
        bound = max(GRAD_RTOL, min(2 * o, WHOLE_LEAF_CAP))
        assert e <= bound, f"{name}: {e:.3g} > {bound:.3g}"
