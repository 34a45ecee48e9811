"""Dense cached decode as CUDA graph chains against the eager step, on the card.

Marked ``gpu``; the ``cuda`` fixture skips them where no card is present.
Run on a machine with one: ``PYTHONPATH=src python -m pytest -q --noconftest
-m gpu tests/test_torch_decode_graphs_cuda.py``.  At the full widths of
the dense-attention configurations the engine serves, stores of 600
positions (so the decode walk runs two splits and its combine), the graph
path (``StagePrograms.stage_decode``) is held bit for bit to the eager
``steps.stage_decode``: stablelm-1.6b (a stage of 6 layers, 32 heads of 64,
G 1) and glm4-9b (10 layers, 32 heads on 2 KV heads of 128, G 16) whole,
internlm2-20b (48 heads on 8, G 6) and qwen2.5-32b (40 on 8, G 5) cut to
4 layers a stage.  Held to it: the output and every store leaf, for every
padded batch from 1 to 32 rows over 8 consecutive tokens, in a workspace
reserved for 32 rows; two replicas of a stage interleaved with another
stage's chain; a store shorter than the workspace (its real rows and
every leaf); chains captured again after the workspace grew; an output
held across the next replay; and a wrapper installed on
``kernels.ops.decode_attention``, as the benchmark installs one, sees one
call a layer.
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import model as model_lib
from repro_torch.serving import steps
from repro_torch.serving.engine import StagePrograms

pytestmark = pytest.mark.gpu

SLOTS = 40  # the trash slot is SLOTS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (configuration, layers kept: None for all of them)
MODELS = [("stablelm-1.6b", None), ("glm4-9b", None), ("internlm2-20b", 16),
          ("qwen2.5-32b", 16)]


@pytest.fixture(params=MODELS, ids=[arch for arch, _ in MODELS])
def stage_programs(request, cuda):
    arch, num_layers = request.param
    cfg = configs.get_config(arch)
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    params = model_lib.init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    return cfg, StagePrograms(params, cfg, cuda)


def _store(programs, stage: int, max_len: int, seed: int):
    """A stage's dense store: random K/V, real slots' ``pos`` below
    ``max_len - 16``, the trash slot's past ``max_len``."""
    g = torch.Generator(device=programs.device).manual_seed(seed)
    store = programs.init_slot_caches(stage, SLOTS + 1, max_len)
    for d in store:
        for leaf in ("k", "v"):
            d[leaf].copy_(torch.randn(d[leaf].shape, generator=g, device=programs.device)
                          .to(d[leaf].dtype))
        pos = torch.randint(1, max_len - 16, (SLOTS + 1,), generator=g, device=programs.device,
                            dtype=torch.int32)
        pos[-1] = max_len + 5
        d["pos"].copy_(pos.expand_as(d["pos"]))
    return store


def _clone(store):
    return tuple({k: t.clone() for k, t in d.items()} for d in store)


def _equal_stores(a, b) -> bool:
    return all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)


def _x(cfg, rows: int, seed: int, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((rows, 1, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)


def _slots(Bp: int):
    """``Bp - 1`` real rows and a padded row on the trash slot (one real row at Bp 1)."""
    real = list(range(max(Bp - 1, 1)))
    return real + [SLOTS] * (Bp - len(real))


def test_graph_decode_is_eager_decode_at_every_batch(stage_programs):
    cfg, programs = stage_programs
    dev = programs.device
    programs.reserve_decode_rows(32)
    eager = _store(programs, 2, 600, seed=1)
    graphed = _clone(eager)
    n = 0
    for Bp in range(1, 33):
        slots = _slots(Bp)
        idx = torch.tensor(slots, dtype=torch.int64, device=dev)
        for token in range(8):
            x = _x(cfg, Bp, 1000 * Bp + token, dev)
            y_e = steps.stage_decode(programs.params, x, eager, idx, cfg, 2)
            y_g = programs.stage_decode(2, x, graphed, slots)
            n += 1
            assert torch.equal(y_g, y_e), (Bp, token)
            assert _equal_stores(graphed, eager), (Bp, token)
    assert (programs.decode_graph_replays, programs.decode_eager) == (n, 0)
    assert programs.decode_graph_captures == 32  # one a batch size: the workspace never grew
    assert programs.decode_graphs.workspace.rows == 32


def test_replicas_a_shorter_store_a_held_output_and_the_wrapped_attention(stage_programs):
    cfg, programs = stage_programs
    dev = programs.device
    stores = {"a": _store(programs, 2, 600, 1), "b": _store(programs, 2, 600, 2),
              "c": _store(programs, 3, 600, 3), "short": _store(programs, 2, 300, 4)}
    stage_of = {"a": 2, "b": 2, "c": 3, "short": 2}
    eager = {k: _clone(s) for k, s in stores.items()}
    real_rows = [0, 7, 13, 21, 30]
    calls = []
    real = kernel_ops.decode_attention

    def wrapped(*a):
        calls.append(tuple(a[1].shape))
        return real(*a)

    # 5 real rows padded to 8; at 16 rows the workspace grows, and the
    # (2, 8) chain is captured again, with no eager run before it
    order = [("a", 8), ("c", 8), ("b", 8), ("a", 8), ("short", 8), ("b", 8), ("c", 16),
             ("short", 8), ("a", 8), ("b", 8)]
    held = None
    for step, (name, Bp) in enumerate(order):
        slots = real_rows + [SLOTS] * (Bp - len(real_rows))
        idx = torch.tensor(slots, dtype=torch.int64, device=dev)
        x = _x(cfg, Bp, step, dev)
        y_e = steps.stage_decode(programs.params, x, eager[name], idx, cfg, stage_of[name])
        kernel_ops.decode_attention = wrapped
        try:
            y_g = programs.stage_decode(stage_of[name], x, stores[name], slots)
        finally:
            kernel_ops.decode_attention = real
        layers = cfg.stage_periods()
        assert len(calls) == sum(layers[stage_of[n] - 1] for n, _ in order[:step + 1])
        assert torch.equal(y_g[:5], y_e[:5]), (step, name)
        if name != "short":  # the shorter store's trash rows read the longer rows
            assert torch.equal(y_g, y_e), (step, name)
        assert _equal_stores(stores[name], eager[name]), (step, name)
        if held is not None:
            assert torch.equal(held[0], held[1]), step
        held = (y_g[2:3], y_g[2:3].clone())
    assert [shape[0] for shape in calls] == [Bp for name, Bp in order
                                             for _ in range(cfg.stage_periods()[stage_of[name] - 1])]
    assert all(shape[1:] == (600, cfg.num_kv_heads, cfg.head_dim) for shape in calls)
    assert programs.decode_graph_captures == 4  # (2, 8), (3, 8); (3, 16); (2, 8) again
