"""The port's loops over a stacked operand take its pieces once, so their
backward writes each piece's gradient once and joins the pieces once.

The loops: a stage's periods (``model._run_stage`` unbinds each stacked
leaf, outside the per-period recompute), sLSTM's time loop
(``layers.loop_scan``), the chunk loops of ``ssm.ssd_chunked`` and
``ssm.mlstm_chunked``, and the chunks of ``model.chunked_xent`` and
``attention.chunked_attention`` (``layers.pieces``: one ``torch.split``).
The loops they replace indexed the operand once a step; the backward of
each index wrote a zero tensor of the whole operand, and autograd added
those up: O(n^2) bytes for n steps, where the reference's scan writes O(n).

The yardstick is those indexing loops, swapped in (``_indexing_loops``):
the period loop and the time loop as they were written, and every other
piece taken by its own index (``t[:, i]``, ``t[:, i:i + c]``) where the port
now unbinds or splits.

  (a) The loss, its metrics and every gradient are bit for bit the
      yardstick's (``torch.equal``): reduced stablelm-1.6b at 24 layers (6
      periods a stage) at S 32, reduced xlstm-350m at S 64 and reduced
      zamba2-2.7b at S 128 (B 2, seeded f32 masters, one ``loss_fn``
      backward), and ``chunked_xent`` / ``chunked_attention`` called with
      a chunk smaller than S.
  (b) The bytes that the backward's ops return (``_Bytes``, a
      ``TorchDispatchMode``) grow linearly: from n to 2n periods a stage,
      sLSTM steps or SSD chunks they may grow at most 2.2x as much as from
      n / 2 to n (exactly 2x for a linear count; zamba2's attention blocks
      are quadratic in S, which its 2.12x holds).  ``select_backward``
      returns at most 1 MB in each backward (the period and chunk loops
      none; what is left is ``causal_conv1d``'s K = 4 taps of its weight),
      and ``slice_backward`` nothing at the chunked heads and attention.
      On the indexing loops these fail: the growth ratios are 2.91x
      (stablelm), 2.35x (xlstm) and 2.27x (zamba2), ``select_backward``
      returns 94.9 MB at 24 layers.  Reduced stablelm at 24 layers returns
      364 MB in all (538 MB indexed), xlstm at S 128 1,126 MB (1,434 MB).
"""
import functools
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_config
from repro_torch.models import attention, layers, model
from repro_torch.sharding import constrain

torch.set_num_threads(1)

B = 2
GROWTH_MAX = 2.2
SELECT_MAX_BYTES = 1 << 20
# (arch, S, num_layers or None): the three points of each growth check, the
# middle one also held bit for bit
GROWTH = {
    "stablelm-1.6b": [("stablelm-1.6b", 32, n) for n in (12, 24, 48)],
    "xlstm-350m": [("xlstm-350m", s, None) for s in (32, 64, 128)],
    "zamba2-2.7b": [("zamba2-2.7b", s, None) for s in (64, 128, 256)],
}
TOTAL_MAX_BYTES = {("stablelm-1.6b", 32, 24): 380e6, ("xlstm-350m", 128, None): 1150e6}


class _Bytes(TorchDispatchMode):
    """The bytes of the tensors every op returns, by op."""

    def __init__(self):
        super().__init__()
        self.by_op: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        n = sum(t.numel() * t.element_size() for t in tree_leaves(out)
                if isinstance(t, torch.Tensor))
        name = func._overloadpacket.__name__
        self.by_op[name] = self.by_op.get(name, 0) + n
        return out


# -- the indexing loops (the yardstick) ---------------------------------------


def _indexing_period_apply(blocks, i, x, aux, cfg, positions, mode, max_len):
    """Period ``i`` of a stage, each block's weights indexed inside the
    recompute (``model._period``), as the period loop was written."""
    caches = []
    for j, kind in enumerate(cfg.period):
        x, cache, a = model._block_apply(kind, model._period(blocks[j], i), x, cfg, positions,
                                         mode, max_len)
        caches.append(cache)
        aux = model._add_aux(aux, a)
    seq = "seq" if os.environ.get("REPRO_SP", "1") == "1" else None
    return constrain(x, "batch", seq, None), aux, caches


def _indexing_run_stage(stage, x, cfg, positions, mode, max_len=0):
    """``model._run_stage`` as it was, in mode ``"train"`` (no caches)."""
    assert mode == "train"
    aux = None
    for i in range(model._num_periods(stage)):
        args = (stage["blocks"], i, x, aux, cfg, positions, mode, max_len)
        if torch.is_grad_enabled():
            x, aux, _ = torch.utils.checkpoint.checkpoint(_indexing_period_apply, *args,
                                                          use_reentrant=False)
        else:
            x, aux, _ = _indexing_period_apply(*args)
    return x, None, aux


def _indexing_loop_scan(body, carry, xs, params=()):
    """``layers.loop_scan`` as it was."""
    ys = []
    for t in range(xs.shape[1]):
        carry, y = body(carry, xs[:, t])
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


def _index_each(t, dim=0):
    """``t.unbind(dim)`` as one index a piece."""
    return tuple(t[(slice(None),) * dim + (i,)] for i in range(t.shape[dim]))


def _slice_each(t, size, dim=0):
    """``torch.split(t, size, dim)`` as one slice a piece."""
    return tuple(t[(slice(None),) * dim + (slice(i, i + size),)]
                 for i in range(0, t.shape[dim], size))


@pytest.fixture
def indexing_loops(monkeypatch):
    """A call swaps the indexing loops in for the rest of the test."""
    def swap():
        monkeypatch.setattr(model, "_run_stage", _indexing_run_stage)
        monkeypatch.setattr(layers, "_scan_impl", _indexing_loop_scan)
        for owner in (torch, torch.Tensor):
            monkeypatch.setattr(owner, "unbind", _index_each)
        monkeypatch.setattr(torch, "split", _slice_each)

    return swap


# -- one loss_fn backward ------------------------------------------------------


def _backward(arch, S, num_layers, count: bool):
    """``(loss, metrics, grads, bytes by op or None)`` of one ``loss_fn``
    backward of reduced ``arch`` at B 2 and ``S`` (seeded f32 masters; the
    tokens and labels from numpy)."""
    cfg = get_config(arch).reduced(**({} if num_layers is None else {"num_layers": num_layers}))
    params = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", master=True)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).int()
             for k in ("tokens", "labels")}
    loss, metrics = model.loss_fn(params, batch, cfg)
    mode = _Bytes() if count else None
    if count:
        with mode:
            loss.backward()
    else:
        loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        [t.grad for t in leaves], mode and mode.by_op


@functools.lru_cache(maxsize=None)
def _counted(arch, S, num_layers):
    return _backward(arch, S, num_layers, count=True)


def _assert_same(now, before):
    loss, metrics, grads, _ = now
    loss_b, metrics_b, grads_b, _ = before
    assert torch.equal(loss, loss_b)
    assert metrics.keys() == metrics_b.keys()
    for k in metrics:
        assert torch.equal(metrics[k], metrics_b[k]), k
    assert len(grads) == len(grads_b)
    for i, (g, g_b) in enumerate(zip(grads, grads_b)):
        assert g is not None and g_b is not None, i
        assert g.dtype == g_b.dtype and torch.equal(g, g_b), i


@pytest.mark.parametrize("arch", list(GROWTH))
def test_loss_and_grads_bit_for_bit_as_the_indexing_loops(arch, indexing_loops):
    point = GROWTH[arch][1]
    now = _counted(*point)
    indexing_loops()
    _assert_same(now, _backward(*point, count=False))


@pytest.mark.parametrize("arch", list(GROWTH))
def test_backward_bytes_grow_linearly(arch):
    totals = [_counted(*point)[3] for point in GROWTH[arch]]
    t = [sum(by_op.values()) for by_op in totals]
    ratio = (t[2] - t[1]) / (t[1] - t[0])
    assert 0 < ratio <= GROWTH_MAX, ([round(x / 1e6, 1) for x in t], ratio)
    for point, by_op in zip(GROWTH[arch], totals):
        assert by_op.get("select_backward", 0) <= SELECT_MAX_BYTES, (point, by_op["select_backward"])
        if point in TOTAL_MAX_BYTES:
            assert sum(by_op.values()) <= TOTAL_MAX_BYTES[point], (point, sum(by_op.values()))


# -- the chunked heads and attention, called directly --------------------------


def _xent_case():
    g = torch.Generator().manual_seed(1)
    rng = np.random.default_rng(1)
    hidden = torch.randn((B, 64, 32), generator=g).bfloat16().requires_grad_(True)
    head = torch.randn((32, 96), generator=g).requires_grad_(True)
    labels = torch.from_numpy(rng.integers(-1, 96, (B, 64))).int()  # -1: masked

    def run():
        nll, cnt = model.chunked_xent(hidden, labels, head, chunk=16)
        return (nll, cnt), torch.autograd.grad(nll, [hidden, head])

    return run, hidden


def _attention_case():
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((B, 48, h, 16), generator=g).bfloat16().requires_grad_(True)
               for h in (4, 2, 2))
    pos = torch.arange(48, dtype=torch.int32)
    ct = torch.randn((B, 48, 4, 16), generator=g)

    def run():
        out = attention.chunked_attention(q, k, v, pos, pos, groups=2, q_chunk=16)
        return (out,), torch.autograd.grad(torch.sum(out.float() * ct), [q, k, v])

    return run, q


@pytest.mark.parametrize("case", [_xent_case, _attention_case], ids=["chunked_xent",
                                                                     "chunked_attention"])
def test_chunked_heads_and_attention(case, indexing_loops):
    run, operand = case()
    with _Bytes() as mode:
        out, grads = run()
    assert mode.by_op.get("slice_backward", 0) == 0
    indexing_loops()
    with _Bytes() as before:
        out_b, grads_b = run()
    # the indexing loop's slices each wrote a zero tensor of all of the operand
    n_chunks = operand.shape[1] // 16
    assert before.by_op["slice_backward"] == n_chunks * operand.numel() * operand.element_size()
    for a, b in zip((*out, *grads), (*out_b, *grads_b)):
        assert a.dtype == b.dtype and torch.equal(a, b)
