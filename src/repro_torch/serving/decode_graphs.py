"""Dense cached decode as a chain of CUDA graphs, with each layer's decode
attention launched eagerly between them.

A dense decode stage batch (``steps.stage_decode``) is ~100 small kernels
a layer.  Launched one by one they cost the host several times the device
time they stand for.  Here they are replayed as ``n_layers + 1`` captured
graphs per key (stage, padded batch), cut at each layer's call to
``kernels.ops.decode_attention``.  That call stays eager between the
graphs, looked up on the module at call time as ``models.attention`` looks
it up, so whatever wraps it sees every call:

  graph 0   the stage input, ``norm1``, the first layer's ``pre`` half
  graph l   layer l's ``post`` half, residual, ``norm2``, FFN, residual,
            ``norm1``, layer l + 1's ``pre`` half
  graph n   the last layer's ``post`` half and tail, the rows' new ``pos``

The halves are ``models.model.attn_decode_open`` / ``attn_decode_close``,
the ones the eager step runs too.  A batch copies its input into the key's
static buffer, gathers its rows' arenas from the replica's store into the
workspace, replays the chain, scatters the rows back
(``steps.slot_write``) and clones the output out of the last graph's
buffer, since the engine keeps views of a stage's output until a later
batch.  The gather and the scatter stay eager: a serve allocates its slot
stores anew, and the two replicas of a stage share the key's graphs.

The workspace holds the gathered ``k`` / ``v`` / ``pos`` of every key, one
flat buffer a leaf: a key's leaves are contiguous views of its prefix,
``[n_periods, Bp, max_len, ...]`` with ``max_len`` the longest store seen.
A store with a shorter ``max_len`` fills the first ``max_len`` positions
of each row.  That changes no value: a real row never reaches past its
store's ``max_len``, and the decode kernel's output for a row depends on
the row's own length alone (fixed ``SPLIT_KEYS`` splits).  Growing the
workspace drops every key's graphs; each is captured again at its next use.
The engine reserves its largest padded batch's rows at a serve's start
(``reserve``): a serve grows the workspace at its first decode batch and
then only for a store longer than any seen, and a stage's first batch
captures the chains of every padded batch size up to the reserved rows, so
that no later batch of the serve waits for a capture.  Graphs never run
at once, so they share one memory pool.
"""
from __future__ import annotations

import math
from time import perf_counter
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import model as model_lib
from repro_torch.sharding import is_dtensor

from . import steps
from .batching import padded_batch_size

# the block kinds a graph chain runs: attention with a dense FFN
GRAPH_KINDS = ("attn", "dense_attn")
# a dense slot store's leaves, per period kind
DENSE_LEAVES = frozenset(("k", "v", "pos"))


def engages(cfg: ArchConfig, x: torch.Tensor, slot_caches) -> bool:
    """Whether a dense decode batch of ``x`` against ``slot_caches`` runs as
    graphs: on a CUDA device, against the dense slot store, with no
    DTensor, and every kind of ``cfg.period`` an attention block with
    neither MLA nor MoE.  Anything else runs eagerly."""
    if x.device.type != "cuda" or is_dtensor(x) or cfg.mla is not None:
        return False
    if any(kind not in GRAPH_KINDS for kind in cfg.period):
        return False
    return all(isinstance(d, dict) and d.keys() == DENSE_LEAVES
               and not any(is_dtensor(t) for t in d.values()) for d in slot_caches)


class Workspace:
    """The gathered rows of every key: one flat buffer a (period kind,
    leaf), holding ``rows`` batch rows of ``max_len`` positions for up to
    ``periods`` periods."""

    def __init__(self):
        self.rows = self.max_len = self.periods = 0
        self.flat: dict[tuple[int, str], torch.Tensor] = {}

    def fits(self, slot_caches, rows: int) -> bool:
        """Whether it holds ``rows`` rows of the store ``slot_caches``."""
        return (rows <= self.rows and slot_caches[0]["k"].shape[2] <= self.max_len
                and slot_caches[0]["pos"].shape[0] <= self.periods)

    def grow(self, slot_caches, rows: int) -> None:
        """Allocate the buffers anew (zeroed, so a position read before any
        gather is in range), to hold ``rows`` rows of the store
        ``slot_caches`` and what they held room for: every view taken
        before is stale.  Drop those views first, so that the old buffers
        are freed before the new ones are made."""
        self.rows = max(self.rows, rows)
        self.max_len = max(self.max_len, slot_caches[0]["k"].shape[2])
        self.periods = max(self.periods, slot_caches[0]["pos"].shape[0])
        self.flat = {}
        for j, d in enumerate(slot_caches):
            for leaf, t in d.items():
                self.flat[(j, leaf)] = torch.zeros(self.periods * self._row_numel(t),
                                                   dtype=t.dtype, device=t.device)

    def _row_numel(self, t: torch.Tensor) -> int:
        """Elements of one period's ``rows`` rows of the store leaf ``t``
        ``[n, slots, ...]`` (``pos``) or ``[n, slots, max_len, ...]``."""
        tail = t.shape[3:] if t.ndim > 2 else ()
        return self.rows * (self.max_len if t.ndim > 2 else 1) * math.prod(tail)

    def views(self, slot_caches, periods: int, rows: int) -> tuple[dict, ...]:
        """A key's leaves, shaped as ``slot_caches``' leaves with ``periods``
        periods, ``rows`` rows and the workspace's ``max_len``: contiguous
        views of each flat buffer's prefix."""
        out = []
        for j, d in enumerate(slot_caches):
            views = {}
            for leaf, t in d.items():
                shape = (periods, rows) + ((self.max_len,) + tuple(t.shape[3:]) if t.ndim > 2
                                           else ())
                views[leaf] = self.flat[(j, leaf)][:math.prod(shape)].view(shape)
            out.append(views)
        return tuple(out)


def rows_of(view: torch.Tensor, store_leaf: torch.Tensor) -> torch.Tensor:
    """The part of a workspace view that a store leaf's rows fill: the
    first ``max_len`` positions of each row where the leaf has a sequence
    dim (``k`` / ``v``), the whole view otherwise (``pos``)."""
    return view[:, :, :store_leaf.shape[2]] if store_leaf.ndim > 2 else view


class CudaGraph:
    """One CUDA graph on ``device``, recorded into the memory pool ``pool``,
    or into a new one where None; ``pool`` names it for the next graph."""

    _streams: dict[torch.device, torch.cuda.Stream] = {}  # a capture stream a device

    def __init__(self, device: torch.device, pool=None):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool

    def capture(self, fn):
        """Record ``fn`` and return its outputs.  CUDA records no graph on
        the default stream, so the recording runs on the device's capture
        stream, after the work queued on its current stream, which then
        waits for it.  (``torch.cuda.graph`` does the same, but also
        synchronizes the device and empties the allocator's cache at every
        capture.)"""
        side = self._streams.get(self.device)
        if side is None:
            side = self._streams[self.device] = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.graph.capture_begin(pool=self.pool)
            try:
                out = fn()
            finally:
                self.graph.capture_end()
        current.wait_stream(side)
        return out

    def replay(self) -> None:
        self.graph.replay()


class _Chain(NamedTuple):
    """One key's graphs and the static tensors they read and write."""
    x: torch.Tensor  # the stage input [Bp, 1, d]
    attn: torch.Tensor  # the attention output each graph after the first reads [Bp, H, hd]
    caches: tuple  # the key's workspace views
    graphs: list
    calls: list  # decode_attention's arguments, a layer each
    out: torch.Tensor  # the stage output [Bp, 1, d]
    pos: tuple  # the rows' new pos [n, Bp], a period kind each


class DecodeGraphs:
    """The graph chains of one set of stage parameters (``StagePrograms``),
    keyed by (stage, padded batch) and captured at first use.
    ``new_graph(device, pool)`` makes a graph (default ``CudaGraph``) in
    the memory pool ``pool`` (None: a new one, named by its ``pool``); a
    graph's ``capture(fn)`` records ``fn`` and returns its outputs,
    ``replay()`` runs it again into them."""

    def __init__(self, params: Any, cfg: ArchConfig, new_graph=CudaGraph):
        self.params = params
        self.cfg = cfg
        self.new_graph = new_graph
        self.workspace = Workspace()
        self.chains: dict[tuple[int, int], _Chain] = {}
        self.captures = 0
        self.capture_s = 0.0
        self._pool = None
        self._rows = 0  # the rows ``reserve`` asked the workspace to hold
        self._warm: set[tuple[int, int]] = set()  # keys whose pieces have run eagerly once

    def reserve(self, rows: int) -> None:
        """Ready the graphs for batches of up to ``rows`` rows (a serve's
        largest padded batch): from the next batch on the workspace holds
        ``rows`` rows at least, so that no batch up to that size grows it
        and has every chain captured again, and a key's capture takes the
        stage's other padded batch sizes (``padded_batch_size``) with it."""
        self._rows = max(self._rows, rows)

    def run(self, stage_idx: int, x: torch.Tensor, slot_caches, slots: torch.Tensor,
            host_spans=None) -> torch.Tensor:
        """``steps.stage_decode`` of the same arguments, by replay: one
        cached token per row of ``x`` [Bp, 1, d] against the store
        (updated in place); returns the stage output.  ``host_spans``
        records ``stage.capture`` (a capture), ``stage.gather`` (the
        input copy and the gather), ``stage.layers`` (the replays, the
        attention calls and their copies) and ``stage.scatter`` (the
        scatter and the output's clone)."""
        hs = host_spans
        Bp = x.shape[0]
        if not self.workspace.fits(slot_caches, max(Bp, self._rows)):
            self.chains.clear()
            self._pool = None
            self.workspace.grow(slot_caches, max(Bp, self._rows))
        if (stage_idx, Bp) not in self.chains:
            if hs is not None:
                i = hs.begin("stage.capture")
            sizes = {Bp} | {padded_batch_size(n, self._rows) for n in range(1, self._rows + 1)}
            for b in sorted(sizes):
                key = (stage_idx, b)
                if key in self.chains:
                    continue
                t = perf_counter()
                self.chains[key] = self._capture(stage_idx, b, x, slot_caches,
                                                 warm=key not in self._warm)
                self._warm.add(key)
                self.capture_s += perf_counter() - t
                self.captures += 1
            if hs is not None:
                hs.end(i)
        chain = self.chains[(stage_idx, Bp)]
        if hs is not None:
            i = hs.begin("stage.gather")
        chain.x.copy_(x)
        for d, w in zip(slot_caches, chain.caches):
            for leaf, t in d.items():
                torch.index_select(t, 1, slots, out=rows_of(w[leaf], t))
        if hs is not None:
            i = hs.switch(i, "stage.layers")
        chain.graphs[0].replay()
        for graph, args in zip(chain.graphs[1:], chain.calls):
            chain.attn.copy_(kernel_ops.decode_attention(*args))
            graph.replay()
        if hs is not None:
            i = hs.switch(i, "stage.scatter")
        rows = tuple({leaf: (pos if leaf == "pos" else rows_of(w[leaf], t))
                      for leaf, t in d.items()}
                     for d, w, pos in zip(slot_caches, chain.caches, chain.pos))
        steps.slot_write(slot_caches, rows, slots)
        out = chain.out.clone()
        if hs is not None:
            hs.end(i)
        return out

    def _capture(self, stage_idx: int, Bp: int, x: torch.Tensor, slot_caches,
                 warm: bool) -> _Chain:
        """Capture the chain of the key (``stage_idx``, ``Bp``), a graph a
        piece, for stage inputs shaped as ``x`` but for their ``Bp`` rows.
        With ``warm``, at a key's first capture, each piece runs once
        eagerly first, so that whatever its kernels set up at first use
        (libraries' handles and plans, lazily loaded modules) is done
        before the recording; a key captured again after the workspace
        grew needs no such run."""
        cfg = self.cfg
        layers = model_lib.decode_layers(self.params["stages"][stage_idx - 1], cfg)
        caches = self.workspace.views(slot_caches, cfg.stage_periods()[stage_idx - 1], Bp)
        # zeros, as the workspace: the pieces' first run reads what these hold
        x_in = x.new_zeros((Bp,) + tuple(x.shape[1:]))
        dims = cfg.attn_dims()
        attn = torch.zeros((Bp, dims.num_heads, dims.head_dim), dtype=caches[0]["k"].dtype,
                           device=x.device)

        def layer_cache(j: int, i: int) -> dict:
            return {leaf: t[i] for leaf, t in caches[j].items()}

        def piece(n: int):
            """Piece ``n`` of the chain: ``outs`` the earlier pieces'
            outputs, each ``(x, (q, lengths))`` but the last's ``(x, pos)``."""
            def run(outs: list):
                h = x_in
                if n > 0:
                    kind, _, _, p = layers[n - 1]
                    h = model_lib.attn_decode_close(kind, p, outs[n - 1][0], attn, cfg)
                if n < len(layers):
                    _, j, i, p = layers[n]
                    return h, model_lib.attn_decode_open(p, h, layer_cache(j, i), cfg)
                pos = tuple(torch.stack([o[1][1] for o, (_, j_, _, _) in zip(outs, layers)
                                         if j_ == j]) for j in range(len(cfg.period)))
                return h, pos
            return run

        pieces = [piece(n) for n in range(len(layers) + 1)]
        with torch.no_grad():
            if warm:
                first: list = []
                for run in pieces:
                    first.append(run(first))
                del first
            outs: list = []
            graphs = []
            for run in pieces:
                graphs.append(self.new_graph(x.device, self._pool))
                self._pool = graphs[-1].pool
                outs.append(graphs[-1].capture(lambda run=run: run(outs)))
        calls = [(q[:, 0], caches[j]["k"][i], caches[j]["v"][i], lengths)
                 for (_, (q, lengths)), (_, j, i, _) in zip(outs, layers)]
        return _Chain(x_in, attn, caches, graphs, calls, outs[-1][0], outs[-1][1])
