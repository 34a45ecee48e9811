"""The port's training runtime against the JAX package's: the int8 codec
with error feedback, ``CheckpointManager`` (the reference's tests, and
checkpoints restored across the two packages both ways), the training token
stream and its resume, ``python -m repro_torch.launch.train`` run, killed and
resumed, and the kernel wrappers' refusal of inputs that need a gradient."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.data import DataConfig as JDataConfig
from repro.data import token_stream as jtoken_stream
from repro.runtime import CheckpointManager as JCheckpointManager
from repro.runtime import compression as jcomp
from repro_torch import configs as tconfigs
from repro_torch.data import DataConfig, token_stream
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as kdec
from repro_torch.kernels import exit_confidence as kexit
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import paged_decode_attention as kpaged
from repro_torch.runtime import CheckpointManager
from repro_torch.runtime import compression

from torch_train_common import torch_leaves_like

SRC = Path(__file__).resolve().parents[1] / "src"


# ---------------------------------------------------------------------------
# int8 codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.01, 1.0, 300.0])
def test_int8_codec_bitwise_against_reference(scale):
    """q, scale and the dequantized values bit for bit, with values placed
    on exact halves of the step so rounding half to even shows."""
    rng = np.random.default_rng(int(scale * 100))
    x = (rng.standard_normal((64, 48)) * scale).astype(np.float32)
    x[0, :6] = np.float32(np.abs(x).max()) / 127.0 * np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5],
                                                               np.float32)
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = compression.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(compression.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jcomp.dequantize_int8(jq, js)))


def test_int8_roundtrip_error_bound():
    """The reference's test on the port."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((64, 64)) * 0.01).astype(np.float32))
    q, s = compression.quantize_int8(x)
    back = compression.dequantize_int8(q, s)
    assert float(torch.max(torch.abs(back - x))) <= float(s) * 0.5 + 1e-9


def test_error_feedback_tracks_reference_and_stays_unbiased():
    """Fifty steps of ``compress_tree`` with error feedback on the same
    grads in both packages: q, scales and residuals bit for bit at every
    step, and the sum sent tracks the true sum within one step (the
    reference's bound)."""
    rng = np.random.default_rng(1)
    true_sum = np.zeros((8, 8), np.float32)
    sent_sum = np.zeros((8, 8), np.float32)
    jerr = jcomp.init_error({"g": jnp.zeros((8, 8)), "h": jnp.zeros((3,))})
    terr = compression.init_error({"g": torch.zeros(8, 8), "h": torch.zeros(3)})
    for _ in range(50):
        g = {"g": (rng.standard_normal((8, 8)) * 0.1).astype(np.float32),
             "h": rng.standard_normal(3).astype(np.float32)}
        jq, js, jerr = jcomp.compress_tree(jax.tree.map(jnp.asarray, g), jerr)
        tq, ts, terr = compression.compress_tree({k: torch.from_numpy(v) for k, v in g.items()},
                                                 terr)
        for k in g:
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
            np.testing.assert_array_equal(terr[k].numpy(), np.asarray(jerr[k]))
            assert float(ts[k]) == float(js[k])
        sent = compression.decompress_tree(tq, ts)
        true_sum += g["g"]
        sent_sum += sent["g"].numpy()
    assert np.abs(true_sum - sent_sum).max() < 0.02


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "layer": {"w": torch.randn(8, 16, generator=g), "b": torch.zeros(16)},
        "stack": [torch.ones(3, 3), torch.arange(5, dtype=torch.int32)],
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _meta(tree):
    return torch.utils._pytree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                              device="meta"), tree)


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(7, tree, extra={"note": "hi"})
    restored, manifest = mgr.restore(_meta(tree))
    assert manifest["step"] == 7 and manifest["extra"]["note"] == "hi"
    for a, b in zip(torch.utils._pytree.tree_leaves(tree), torch.utils._pytree.tree_leaves(restored)):
        assert a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)
    back, _ = mgr.restore(tree)  # a tree of tensors as the target
    assert torch.equal(back["layer"]["w"], tree["layer"]["w"])


def test_checkpoint_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.latest_step() == 4
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_rejects_shape_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(4, 4)})
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.empty(5, 4, device="meta")})


def test_checkpoint_rejects_missing_leaf(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(4)})
    with pytest.raises((KeyError, ValueError)):
        mgr.restore({"q": torch.empty(4, device="meta")})
    with pytest.raises(ValueError):
        mgr.restore({"w": torch.empty(4, device="meta"), "q": torch.empty(4, device="meta")})


def test_checkpoint_torn_write_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    os.makedirs(tmp_path / "step_00000009.tmp-999", exist_ok=True)  # a crashed writer's
    assert mgr.latest_step() == 1 and mgr.all_steps() == [1]
    restored, manifest = mgr.restore(_meta(_tree()))
    assert manifest["step"] == 1
    # LATEST naming a step whose manifest never landed falls back to the newest whole one
    (tmp_path / "LATEST").write_text("step_00000009")
    assert mgr.latest_step() == 1


def test_checkpoint_refuses_bf16(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(TypeError):
        mgr.save(1, {"w": torch.zeros(4, dtype=torch.bfloat16)})


def test_checkpoint_restores_across_packages_both_ways(tmp_path):
    """The same f32 / int32 tree (a params-and-optimizer-state pair) saved
    by one package restores in the other bit for bit, with the same leaf
    names, in both directions; a bf16 leaf from the reference is refused."""
    tree = _tree(3)
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)
    pair_t, pair_j = (tree, {"m": tree["stack"]}), (jtree, {"m": jtree["stack"]})

    CheckpointManager(str(tmp_path / "t")).save(5, pair_t, {"arch": "x"})
    back_j, manifest = JCheckpointManager(str(tmp_path / "t")).restore(jax.eval_shape(lambda: pair_j))
    assert manifest["step"] == 5
    for a, b in zip(torch_leaves_like(pair_t), jax.tree.leaves(back_j)):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())
        assert np.asarray(b).dtype == a.numpy().dtype

    JCheckpointManager(str(tmp_path / "j")).save(6, pair_j)
    back_t, manifest = CheckpointManager(str(tmp_path / "j")).restore(_meta(pair_t))
    assert manifest["step"] == 6
    names_t = [e["name"] for e in manifest["index"]]
    import json
    with open(tmp_path / "t" / "step_00000005" / "manifest.json") as f:
        assert [e["name"] for e in json.load(f)["index"]] == names_t
    for a, b in zip(torch.utils._pytree.tree_leaves(pair_t), torch.utils._pytree.tree_leaves(back_t)):
        assert torch.equal(a, b)

    JCheckpointManager(str(tmp_path / "b")).save(1, {"w": jnp.zeros((4,), jnp.bfloat16)})
    with pytest.raises(TypeError):
        CheckpointManager(str(tmp_path / "b")).restore({"w": torch.empty(4, device="meta")})


# ---------------------------------------------------------------------------
# token stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "musicgen-medium"])
def test_token_stream_bitwise_against_reference_and_resumes(arch):
    """Four batches of both packages' streams bit for bit (tokens or
    embeddings, and labels, with the wrap-around label masked), and a stream
    resumed at step 3 gives step 3's batch (the reference's resume test)."""
    jcfg = get_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    dcfg = DataConfig(batch_size=2, seq_len=24, seed=4)
    js = jtoken_stream(jcfg, JDataConfig(batch_size=2, seq_len=24, seed=4))
    ts = token_stream(tcfg, dcfg, device="cpu")
    batches = []
    for _ in range(4):
        jb, tb = next(js), next(ts)
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
            assert tb[k].numpy().dtype == np.asarray(jb[k]).dtype
        batches.append(tb)
    if "tokens" in batches[0]:
        assert (batches[0]["labels"][:, -1] == -1).all()
    resumed = next(token_stream(tcfg, dcfg, start_step=3, device="cpu"))
    for k in resumed:
        assert torch.equal(resumed[k], batches[3][k])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _train_cmd(ckpt_dir):
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch", "stablelm-1.6b",
            "--reduced", "--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "2"]


def _env():
    return {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}


def _train(ckpt_dir):
    return subprocess.run(_train_cmd(ckpt_dir), capture_output=True, text=True, env=_env(),
                          timeout=240, check=True).stdout


def _train_killed_after_first_checkpoint(ckpt_dir):
    """The same command, killed once its step-2 checkpoint is written."""
    proc = subprocess.Popen(_train_cmd(ckpt_dir), stdout=subprocess.PIPE, text=True, env=_env())
    try:
        for line in proc.stdout:
            if line.startswith("checkpoint ->"):
                proc.kill()
                break
    finally:
        proc.kill()
        proc.wait(timeout=60)
        proc.stdout.close()


def test_launch_train_resumes_bitwise(tmp_path):
    """``--steps 4`` in one run against the same command killed after its
    step-2 checkpoint and relaunched: the final checkpoints are equal bit
    for bit."""
    out = _train(tmp_path / "a")
    assert "stablelm-1.6b-smoke" in out and "step     3" in out
    _train_killed_after_first_checkpoint(tmp_path / "b")
    assert CheckpointManager(str(tmp_path / "b")).latest_step() == 2
    out = _train(tmp_path / "b")
    assert "restored checkpoint at step 2" in out
    mgr_a, mgr_b = CheckpointManager(str(tmp_path / "a")), CheckpointManager(str(tmp_path / "b"))
    assert mgr_a.latest_step() == mgr_b.latest_step() == 4
    with np.load(tmp_path / "a" / "step_00000004" / "shard_00000.npz") as a, \
            np.load(tmp_path / "b" / "step_00000004" / "shard_00000.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) > 100
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])


def test_launch_train_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                          "stablelm-1.6b", "--reduced", "--steps", "1"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr


# ---------------------------------------------------------------------------
# the kernel wrappers refuse inputs that need a gradient
# ---------------------------------------------------------------------------


def _wrapper_calls(requires_grad):
    """Each wrapper with inputs off the CPU (meta tensors, so nothing runs)."""
    m = dict(device="meta", dtype=torch.bfloat16)
    q3 = torch.empty(2, 4, 64, **m).requires_grad_(requires_grad)
    kv = torch.empty(2, 16, 4, 64, **m)
    lengths = torch.empty(2, dtype=torch.int32, device="meta")
    table = torch.empty(2, 4, dtype=torch.int32, device="meta")
    q4 = torch.empty(2, 16, 4, 64, **m).requires_grad_(requires_grad)
    h = torch.empty(2, 64, **m).requires_grad_(requires_grad)
    w = torch.empty(64, 128, **m)
    return {
        "flash_attention": lambda: kflash.flash_attention(q4, kv, kv),
        "decode_attention": lambda: kdec.decode_attention(q3, kv, kv, lengths),
        "paged_decode_attention": lambda: kpaged.paged_decode_attention(q3, kv, kv, table, lengths),
        "exit_confidence": lambda: kexit.exit_confidence(h, w),
    }


def test_kernel_wrappers_refuse_grad_inputs_before_building(monkeypatch):
    """A kernel's output has no ``grad_fn``: each wrapper raises on an input
    that requires grad while grad is enabled, before it builds or launches
    anything.  Under ``torch.no_grad()``, or without such an input, the same
    call goes on past the guard (and here stops at the device check)."""
    def no_build(name):
        raise AssertionError(f"{name} was built")

    monkeypatch.setattr(build, "load", no_build)
    for name, call in _wrapper_calls(True).items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad(), pytest.raises(ValueError):
            call()
    for name, call in _wrapper_calls(False).items():
        with pytest.raises(ValueError):
            call()
    assert (kflash.flash_attention.launches, kdec.decode_attention.launches) == (0, 0)


def test_cpu_wrappers_keep_the_plain_path_under_grad():
    """On the CPU a wrapper is its plain version, differentiable as it is."""
    q = torch.randn(1, 8, 2, 32, requires_grad=True)
    out = kflash.flash_attention(q, q.detach(), q.detach())
    (g,) = torch.autograd.grad(out.sum(), [q])
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
