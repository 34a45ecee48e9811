"""Dense cached decode as graph chains (``serving/decode_graphs.py``), on the CPU.

The split of a GQA block's ragged decode step at its attention call
(``attention.gqa_decode_ragged_pre`` / ``_post``, ``model.attn_decode_open``
/ ``attn_decode_close``), composed around ``kernels.ops.decode_attention``,
gives bit for bit what the step gave before the split, on reduced stablelm
and glm4 (3 periods a stage) at 1, 3 and 8 rows plus a padded row whose
trash slot lies past ``max_len``.  The chain of ``DecodeGraphs`` runs here
with a stand-in graph that re-runs each captured piece (``EagerGraph``),
against eager ``steps.stage_decode``: outputs and every store leaf bit for
bit, over consecutive tokens, two replicas interleaved with other stages,
a store shorter than the workspace, and an output held across the next
batch; every attention call goes through the module attribute.  A
workspace reserved for the largest batch (as a dense cached serve reserves
it) never grows for a smaller one, and a stage's first batch captures the
chains of every padded batch size up to it.  The rule
that picks the graph path is tested on configurations and devices without
launching anything, and the workspace's view arithmetic on its own.  The
CUDA graphs themselves are held to the eager step on the card
(``tests/test_torch_decode_graphs_cuda.py``).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention, layers
from repro_torch.models import model as model_lib
from repro_torch.serving import decode_graphs, steps
from repro_torch.serving.engine import StagePrograms

torch.set_num_threads(1)

ARCHS = ("stablelm-1.6b", "glm4-9b")


def _cfg(arch: str):
    return configs.get_config(arch).reduced(num_layers=12, vocab_size=128)


def _params(cfg):
    return model_lib.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _store(cfg, stage: int, n_slots: int, max_len: int, seed: int):
    """A replica's dense slot store with ``n_slots`` slots and the trash
    slot last: random K/V, each slot's ``pos`` well inside ``max_len`` and
    the trash slot's past it."""
    g = torch.Generator().manual_seed(seed)
    store = model_lib.init_stage_slot_caches(cfg, stage, n_slots + 1, max_len, device="cpu")
    for d in store:
        for leaf in ("k", "v"):
            d[leaf].copy_(torch.randn(d[leaf].shape, generator=g).to(d[leaf].dtype))
        pos = torch.randint(1, max_len // 2, (d["pos"].shape[1],), generator=g, dtype=torch.int32)
        pos[-1] = max_len + 3
        d["pos"].copy_(pos.expand_as(d["pos"]))
    return store


def _x(cfg, rows: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((rows, 1, cfg.d_model), generator=g).to(torch.bfloat16)


def _clone(store):
    return tuple({k: t.clone() for k, t in d.items()} for d in store)


def _equal_stores(a, b) -> bool:
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def _decode_before_the_split(params, stage_idx, x, caches, cfg):
    """The ragged decode stage as it ran before the split: each block's
    ``gqa_decode_ragged`` in one piece (``pos + 1`` taken twice)."""
    stage = params["stages"][stage_idx - 1]
    dims = cfg.attn_dims()
    pos_out = [[] for _ in cfg.period]
    for i in range(model_lib._num_periods(stage)):
        for j, kind in enumerate(cfg.period):
            p = model_lib._period(stage["blocks"][j], i)
            cache = model_lib._period(caches[j], i)
            h = layers.apply_norm(cfg.norm, p["norm1"], x)
            pos = cache["pos"]
            q, k_new, v_new = attention._project_qkv(p["attn"], h, dims)
            q = layers.apply_rope(q, pos[:, None], dims.rope_theta)
            k_new = layers.apply_rope(k_new, pos[:, None], dims.rope_theta)
            attention._cache_write_ragged(cache["k"], k_new, pos)
            attention._cache_write_ragged(cache["v"], v_new, pos)
            out = kernel_ops.decode_attention(q[:, 0], cache["k"], cache["v"], pos + 1)
            out = layers.matmul(layers.merge_last(out)[:, None], p["attn"]["w_o"])
            x = x + out
            h2 = layers.apply_norm(cfg.norm, p["norm2"], x)
            x = x + model_lib._ffn(kind, p, h2, cfg)[0]
            pos_out[j].append(pos + 1)
    return x, tuple(dict(c, pos=torch.stack(p)) for c, p in zip(caches, pos_out))


def _decode_by_halves(params, stage_idx, x, caches, cfg):
    """The same stage from the halves, the attention call between them."""
    pos_out = [[] for _ in cfg.period]
    for kind, j, i, p in model_lib.decode_layers(params["stages"][stage_idx - 1], cfg):
        cache = model_lib._period(caches[j], i)
        q, lengths = model_lib.attn_decode_open(p, x, cache, cfg)
        out = kernel_ops.decode_attention(q[:, 0], cache["k"], cache["v"], lengths)
        x = model_lib.attn_decode_close(kind, p, x, out, cfg)
        pos_out[j].append(lengths)
    return x, tuple(dict(c, pos=torch.stack(p)) for c, p in zip(caches, pos_out))


class EagerGraph:
    """A graph's stand-in on the CPU: ``capture`` runs ``fn`` and keeps its
    outputs, ``replay`` runs it again and copies the results into them, as a
    replay writes into the captured buffers."""

    def __init__(self, device, pool):
        self.fn = self.out = self.pool = None

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        return self.out

    def replay(self):
        new = self.fn()
        olds, _ = torch.utils._pytree.tree_flatten(self.out)
        news, _ = torch.utils._pytree.tree_flatten(new)
        for old, fresh in zip(olds, news, strict=True):
            if old is not fresh:
                old.copy_(fresh)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = _cfg(request.param)
    return cfg, _params(cfg)


@pytest.mark.parametrize("B", [1, 3, 8])
def test_halves_around_the_attention_call_are_the_step_before_the_split(model, B):
    cfg, params = model
    max_len = 40
    store = _store(cfg, 2, 10, max_len, seed=B)
    slots = torch.tensor(list(range(B)) + [10], dtype=torch.int64)  # the last row: trash
    x = _x(cfg, B + 1, seed=B)
    outs = []
    for fn in (_decode_before_the_split, _decode_by_halves, model_lib.decode_stage_ragged):
        rows = tuple({k: a[:, slots] for k, a in d.items()} for d in store)
        outs.append(fn(params, 2, x, rows, cfg))
    (y0, c0), (y1, c1), (y2, c2) = outs
    assert bool(c0[0]["pos"][0, -1] > max_len)  # the trash row's write fell past the cache
    assert torch.equal(y0, y1) and torch.equal(y0, y2)
    assert _equal_stores(c0, c1) and _equal_stores(c0, c2)


def _graphs(params, cfg):
    return decode_graphs.DecodeGraphs(params, cfg, new_graph=EagerGraph)


@pytest.mark.parametrize("B,Bp", [(1, 1), (3, 4), (8, 8), (5, 8)])
def test_graph_chain_is_the_eager_stage_decode(model, B, Bp):
    cfg, params = model
    max_len = 24
    eager = _store(cfg, 1, 10, max_len, seed=Bp)
    graphed = _clone(eager)
    chains = _graphs(params, cfg)
    slots = torch.tensor(list(range(B)) + [10] * (Bp - B), dtype=torch.int64)
    for token in range(6):
        x = _x(cfg, Bp, seed=100 + token)
        y_e = steps.stage_decode(params, x, eager, slots, cfg, 1)
        y_g = chains.run(1, x, graphed, slots)
        assert torch.equal(y_g, y_e), token
        assert _equal_stores(graphed, eager), token
    assert chains.captures == 1 and len(chains.chains) == 1


def test_replicas_interleaved_a_shorter_store_and_a_held_output():
    cfg = _cfg("stablelm-1.6b")
    params = _params(cfg)
    chains = _graphs(params, cfg)
    calls = []
    real = kernel_ops.decode_attention

    def counted(*a):
        calls.append(a[1].shape)
        return real(*a)

    # two replicas of stage 2 (max_len 32), stage 3 in between, then a
    # store of stage 2 with a shorter max_len (20) than the workspace's
    stores = {"a": _store(cfg, 2, 8, 32, 1), "b": _store(cfg, 2, 8, 32, 2),
              "c": _store(cfg, 3, 8, 32, 3), "short": _store(cfg, 2, 8, 20, 4)}
    stage_of = {"a": 2, "b": 2, "c": 3, "short": 2}
    eager = {k: _clone(s) for k, s in stores.items()}
    slots = torch.tensor([0, 3, 5, 8], dtype=torch.int64)  # three rows and the trash slot
    order = ["a", "c", "b", "a", "b", "c", "short", "a", "short"]
    held = None
    kernel_ops.decode_attention = counted
    try:
        for step, name in enumerate(order):
            x = _x(cfg, 4, seed=step)
            y_e = steps.stage_decode(params, x, eager[name], slots, cfg, stage_of[name])
            n_calls = len(calls)
            y_g = chains.run(stage_of[name], x, stores[name], slots)
            chain_calls = calls[n_calls:]
            assert len(chain_calls) == cfg.stage_periods()[stage_of[name] - 1]
            assert all(shape[1] == 32 for shape in chain_calls)  # on the workspace's rows
            assert torch.equal(y_g[:3], y_e[:3]), (step, name)
            if name != "short":  # the shorter store's trash row sees the longer rows
                assert torch.equal(y_g, y_e), (step, name)
            assert _equal_stores(stores[name], eager[name]), (step, name)
            if held is not None:  # an earlier output, kept as the engine keeps it
                assert torch.equal(held[0], held[1])
            held = (y_g[1:2], y_g[1:2].clone())
    finally:
        kernel_ops.decode_attention = real
    assert chains.captures == 2  # (2, 4) and (3, 4); the shorter store reuses (2, 4)
    assert chains.workspace.max_len == 32


def test_workspace_growth_drops_every_chain():
    cfg = _cfg("glm4-9b")
    params = _params(cfg)
    chains = _graphs(params, cfg)
    small, wide, long = _store(cfg, 1, 8, 16, 1), _store(cfg, 1, 8, 16, 2), _store(cfg, 1, 8, 24, 3)
    chains.run(1, _x(cfg, 2, 0), small, torch.tensor([0, 1]))
    chains.run(1, _x(cfg, 2, 1), small, torch.tensor([1, 2]))
    assert chains.captures == 1
    chains.run(1, _x(cfg, 4, 2), wide, torch.tensor([0, 1, 2, 8]))  # more rows: a new buffer
    assert chains.captures == 2 and list(chains.chains) == [(1, 4)]
    eager = _clone(long)
    x = _x(cfg, 2, 3)
    y = chains.run(1, x, long, torch.tensor([4, 8]))  # a longer store: a new buffer again
    assert chains.captures == 3 and chains.workspace.max_len == 24
    assert torch.equal(y, steps.stage_decode(params, x, eager, torch.tensor([4, 8]), cfg, 1))
    assert _equal_stores(long, eager)


def test_a_reserved_workspace_holds_every_batch_up_to_it():
    cfg = _cfg("glm4-9b")
    params = _params(cfg)
    chains = _graphs(params, cfg)
    chains.reserve(8)
    store = _store(cfg, 1, 8, 16, 1)
    eager = _clone(store)
    for step, Bp in enumerate((1, 2, 4, 8, 2, 1)):
        slots = torch.tensor(list(range(Bp - 1)) + [8])  # the last row padded
        x = _x(cfg, Bp, step)
        y_e = steps.stage_decode(params, x, eager, slots, cfg, 1)
        assert torch.equal(chains.run(1, x, store, slots), y_e), (step, Bp)
        assert _equal_stores(store, eager), (step, Bp)
        assert chains.workspace.rows == 8
        # the first batch captured a chain a padded batch size, and none again
        assert chains.captures == 4
        assert set(chains.chains) == {(1, 1), (1, 2), (1, 4), (1, 8)}
    chains.run(1, _x(cfg, 3, 9), store, torch.tensor([0, 1, 8]))  # not a padded size
    assert chains.captures == 5 and chains.workspace.rows == 8


def _engine(cfg):
    from repro_torch.core.profiles import profile_from_arch
    from repro_torch.core.thresholds import synthetic_validation
    from repro_torch.core.topology import NetworkSpec, build_edge_network
    from repro_torch.core.types import DtoHyperParams
    from repro_torch.serving import CollaborativeEngine

    profile = profile_from_arch(cfg)
    topo = build_edge_network(seed=0, profile=profile,
                              spec=NetworkSpec(num_eds=4, es_per_stage=(2, 2)))
    return CollaborativeEngine(_params(cfg), cfg, topo, profile,
                               synthetic_validation(seed=1, profile=profile),
                               DtoHyperParams(rounds=5), seed=0, device="cpu")


@pytest.mark.parametrize("serve_kw,rows", [
    (dict(gen_len=3, batch_size=4), 4),
    (dict(gen_len=3, batch_size=4, cache_layout="paged", block_size=4), 0),
    (dict(gen_len=1, batch_size=4), 0),  # stateless
])
def test_a_dense_cached_serve_reserves_its_largest_batch(serve_kw, rows):
    cfg = configs.get_config("stablelm-1.6b").reduced(vocab_size=128)
    engine = _engine(cfg)
    engine.configuration_phase()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(4, 9, size=4)]
    engine.serve(prompts, arrival_rate=50.0, **serve_kw)
    assert engine.programs.decode_graphs._rows == rows
    assert engine.programs.decode_graph_captures == 0  # the CPU decodes eagerly


def test_workspace_views_are_contiguous_prefixes_and_shorter_rows_map_into_longer():
    cfg = _cfg("glm4-9b")  # 2 KV heads of 32
    ws = decode_graphs.Workspace()
    long, short = _store(cfg, 1, 8, 16, 1), _store(cfg, 1, 8, 10, 2)
    assert not ws.fits(long, 4)
    ws.grow(long, 4)
    assert ws.fits(long, 4) and ws.fits(short, 2) and not ws.fits(long, 8)
    n = cfg.stage_periods()[0]
    for rows in (1, 2, 4):
        (views,) = ws.views(long, n, rows)
        for leaf, v in views.items():
            flat = ws.flat[(0, leaf)]
            assert v.is_contiguous() and v.data_ptr() == flat.data_ptr()
            want = (n, rows, 16, 2, 32) if leaf in ("k", "v") else (n, rows)
            assert tuple(v.shape) == want
        assert all(views["k"][i].is_contiguous() for i in range(n))  # what the kernel reads
    (views,) = ws.views(short, n, 4)
    slots = torch.tensor([5, 0, 7, 8])
    dst = decode_graphs.rows_of(views["k"], short[0]["k"])
    assert tuple(dst.shape) == (n, 4, 10, 2, 32) and not dst.is_contiguous()
    torch.index_select(short[0]["k"], 1, slots, out=dst)
    flat = ws.flat[(0, "k")]
    row = 2 * 32  # elements of one position
    for i in range(n):
        for b, s in enumerate(slots.tolist()):
            for t in (0, 9):
                at = ((i * 4 + b) * 16 + t) * row
                assert torch.equal(flat[at:at + row].view(2, 32), short[0]["k"][i, s, t])
    assert torch.equal(decode_graphs.rows_of(views["pos"], short[0]["pos"]), views["pos"])


class _Cuda(types.SimpleNamespace):
    """What the rule reads of a CUDA tensor, made without a card."""

    def __init__(self):
        super().__init__(device=torch.device("cuda"))


@pytest.mark.parametrize("arch,engages", [
    ("stablelm-1.6b", True), ("glm4-9b", True), ("internlm2-20b", True),
    ("qwen2.5-32b", True), ("phi-3-vision-4.2b", True), ("musicgen-medium", True),
    ("deepseek-v2-lite-16b", False),  # MLA and MoE
    ("mixtral-8x7b", False),  # MoE
    ("zamba2-2.7b", False),  # Mamba2 beside its dense_attn blocks
    ("xlstm-350m", False),  # mLSTM and sLSTM
])
def test_graph_path_rule_by_config(arch, engages):
    cfg = configs.get_config(arch).reduced()
    store = model_lib.init_stage_slot_caches(cfg, 1, 3, 8, device="meta")
    assert decode_graphs.engages(cfg, _Cuda(), store) is engages
    assert not decode_graphs.engages(cfg, torch.zeros(2, 1, cfg.d_model), store)  # the CPU


def test_graph_path_rule_refuses_the_paged_store_and_dtensors():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.dryrun import fake_world

    cfg = _cfg("stablelm-1.6b")
    dense = model_lib.init_stage_slot_caches(cfg, 1, 3, 8, device="meta")
    pool, state = model_lib.init_stage_paged_caches(cfg, 1, 3, 5, 4, 8, device="meta")
    assert decode_graphs.engages(cfg, _Cuda(), dense)
    assert not decode_graphs.engages(cfg, _Cuda(), pool)
    assert not decode_graphs.engages(cfg, _Cuda(), state)
    assert not decode_graphs.engages(cfg, _Cuda(), (pool, state))
    with fake_world(1):
        mesh = init_device_mesh("cpu", (1,))
        leaf = DTensor.from_local(torch.zeros(2, 3), mesh, [Replicate()])
        assert not decode_graphs.engages(cfg, _Cuda(), (dict(dense[0], pos=leaf),))
        x = DTensor.from_local(torch.zeros(2, 1, cfg.d_model), mesh, [Replicate()])
        assert not decode_graphs.engages(cfg, x, dense)


def test_stage_programs_count_eager_decode_on_the_cpu():
    cfg = _cfg("stablelm-1.6b")
    programs = StagePrograms(_params(cfg), cfg, "cpu")
    store = _store(cfg, 1, 4, 16, 0)
    eager = _clone(store)
    x = _x(cfg, 2, 0)
    y = programs.stage_decode(1, x, store, np.array([0, 2]))
    assert torch.equal(y, steps.stage_decode(programs.params, x, eager, torch.tensor([0, 2]),
                                             cfg, 1))
    assert (programs.decode_eager, programs.decode_graph_replays) == (1, 0)
    assert (programs.decode_graph_captures, programs.decode_graph_capture_s) == (0, 0.0)
