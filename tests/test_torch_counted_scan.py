"""The dry run's counted scan (``launch.dryrun.CostMode`` over
``models.layers.scan``) against the loop it stands for, and the scan on
real tensors against the code it replaced.

  * On reduced xlstm-350m (``.reduced()``), B 4, prefill and train cells at S
    8 and 24 on a (2, 2) ("data", "model") mesh of a fake group of 4: the
    counted scan's FLOPs (in all and per op), bytes and per-kind collective
    bytes and counts equal those of the full loop (``full_scans=True``)
    exactly, and its peak of live bytes is within 1% of the loop's.
  * On real CPU tensors ``layers.scan`` runs its body once a step, and the
    hook ``CostMode`` installs is there only while the mode is active.
  * Reduced xlstm's prefill, decode and train steps give, bit for bit, what
    the sLSTM time loop and mLSTM's head merge as they were written before
    the scan helper give (copied below as ``_loop_slstm_forward`` and
    ``_reshape_mlstm_forward``).
"""
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.models import layers, model, ssm
from repro_torch.serving.steps import make_decode_step, make_prefill_step
from repro_torch.training import AdamWConfig, make_train_step

torch.set_num_threads(1)

PEAK_RTOL = 0.01


def _count(cfg, shape, full_scans):
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        mode, _, _ = dryrun.count_step(cfg, shape, mesh, full_scans=full_scans)
    st = mode.stats(4)
    return mode, st


@pytest.mark.parametrize("mode_name,S", [("prefill", 8), ("prefill", 24), ("train", 8),
                                         ("train", 24)])
def test_counted_scan_equals_the_loop(mode_name, S):
    cfg = get_config("xlstm-350m").reduced()
    shape = ShapeSpec(mode_name, S, 4, mode_name)
    loop, loop_st = _count(cfg, shape, full_scans=True)
    counted, counted_st = _count(cfg, shape, full_scans=False)
    assert counted.flops == loop.flops
    assert counted.bytes == loop.bytes
    assert {k: v for k, v in counted.flops_by_op.items() if v} == {
        k: v for k, v in loop.flops_by_op.items() if v}
    assert counted_st.by_op == loop_st.by_op
    assert counted_st.counts == loop_st.counts
    assert sorted(counted.records) == sorted(loop.records)
    assert counted.peak == pytest.approx(loop.peak, rel=PEAK_RTOL)


def test_scan_runs_the_body_once_a_step_on_real_tensors():
    g = torch.Generator().manual_seed(0)
    xs = torch.randn((3, 7, 5), generator=g)
    w = torch.randn((5, 5), generator=g)
    calls = []

    def body(carry, x_t):
        calls.append(x_t.shape)
        (c,) = carry
        c = torch.tanh(c @ w + x_t)
        return (c,), 2.0 * c

    carry, ys = layers.scan(body, (torch.zeros((3, 5)),), xs, params=(w,))
    c, want = torch.zeros((3, 5)), []
    for t in range(7):
        c = torch.tanh(c @ w + xs[:, t])
        want.append(2.0 * c)
    assert len(calls) == 7
    assert torch.equal(carry[0], c)
    assert torch.equal(ys, torch.stack(want, dim=1))
    # the dry run's count is installed only while its mode is active, and a
    # real tensor under it still runs the loop
    assert layers._scan_impl is layers.loop_scan
    with dryrun.CostMode() as mode:
        assert layers._scan_impl == mode._scan
        calls.clear()
        layers.scan(body, (torch.zeros((3, 5)),), xs, params=(w,))
        assert len(calls) == 7
    assert layers._scan_impl is layers.loop_scan


def _loop_slstm_forward(params, x, dims, initial=None, return_state=False):
    """``ssm.slstm_forward`` as it was before ``layers.scan``."""
    B, S, d = x.shape
    H, P = dims.num_heads, dims.s_head_dim
    w_x = layers.matmul(x, params["w_gates"])
    if initial is None:
        zeros = torch.zeros((B, H, P), dtype=torch.float32, device=x.device)
        initial = (zeros, zeros, zeros, torch.full((B, H, P), -1e30, dtype=torch.float32,
                                                   device=x.device))
    state, hs = initial, []
    for t in range(S):
        state, h_t = ssm.slstm_cell(w_x[:, t], params["r_gates"], params["gate_bias"], state, H, P)
        hs.append(h_t)
    h = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    h = layers.rmsnorm(params["norm_h"], h)
    out = h + layers.glu_ffn(params["ffn"], h)
    if return_state:
        return out, state
    return out


def _reshape_mlstm_forward(params, x, dims, initial=None, return_state=False):
    """``ssm.mlstm_forward`` as it was before ``layers.merge_last``."""
    B, S, _ = x.shape
    H, P = dims.num_heads, dims.m_head_dim
    up = layers.matmul(x, params["up_proj"])
    xi, z = torch.chunk(up, 2, dim=-1)
    conv_out = layers.silu(ssm.causal_conv1d(xi, params["conv_w"], params["conv_b"]))
    q, k, v, i_gate, f_gate = ssm._mlstm_qkv_gates(params, xi, conv_out, (B, S, H, P), P)
    h, state = ssm.mlstm_chunked(q, k, v, i_gate, f_gate, dims.chunk, initial)
    h = h.reshape(B, S, dims.d_inner)
    h = layers.rmsnorm(params["norm_h"], h) * layers.silu(z)
    out = layers.matmul(h, params["down_proj"])
    if return_state:
        return out, state
    return out


def _xlstm_run(cfg):
    """Prefill, three decode steps and one train step of reduced xlstm."""
    g = torch.Generator().manual_seed(0)
    params = model.init_params(cfg, g, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=g, dtype=torch.int64).int()
    th = torch.full((len(cfg.exit_stages),), 2.0)
    out = make_prefill_step(cfg, 16)(params, {"tokens": tokens}, th)
    leaves = [out["exit_conf"], out["token"], *tree_leaves(out["caches"])]
    decode, caches, tok = make_decode_step(cfg), out["caches"], out["token"][:, None]
    for _ in range(3):
        o = decode(params, {"tokens": tok}, caches, th)
        caches, tok = o["caches"], o["token"][:, None]
        leaves += [o["exit_conf"], o["token"]]
    masters = model.init_params(cfg, torch.Generator().manual_seed(1), device="cpu", master=True)
    step = make_train_step(cfg, AdamWConfig())
    from repro_torch.training import optimizer as opt_lib

    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12), generator=g).int(),
             "labels": torch.randint(0, cfg.vocab_size, (2, 12), generator=g).int()}
    new, _, metrics = step(masters, opt_lib.init_opt_state(masters), batch)
    return leaves + tree_leaves(new) + [metrics["loss"]]


def test_xlstm_steps_bit_for_bit_as_before(monkeypatch):
    cfg = get_config("xlstm-350m").reduced()
    now = _xlstm_run(cfg)
    monkeypatch.setattr(ssm, "slstm_forward", _loop_slstm_forward)
    monkeypatch.setattr(ssm, "mlstm_forward", _reshape_mlstm_forward)
    kinds = dict(model._STATE_KINDS)
    kinds["slstm"] = kinds["slstm"]._replace(forward=_loop_slstm_forward)
    kinds["mlstm"] = kinds["mlstm"]._replace(forward=_reshape_mlstm_forward)
    monkeypatch.setattr(model, "_STATE_KINDS", kinds)
    before = _xlstm_run(cfg)
    assert len(now) == len(before)
    for a, b in zip(now, before):
        assert a.dtype == b.dtype and torch.equal(a, b)
