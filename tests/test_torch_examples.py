"""The port's examples (``examples/torch_*.py``) run on the CPU, each in a
subprocess with ``--device cpu``, and end in their closing lines.  The
collaborative-serving example (the control plane and the simulator alone)
prints what the JAX package's ``examples/serve_collaborative.py`` prints,
line for line; the quickstart trains a few steps here (``--steps``; 60 on
the card, in ``chip_smoke.py``)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("import jax", "from jax", "import repro.", "from repro.", "from repro ")


def _run(script: str, *flags: str, jax: bool = False) -> list[str]:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    if jax:
        env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples", script), *flags],
                          capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()


def test_examples_import_only_the_port():
    for name in ("torch_quickstart.py", "torch_serve_collaborative.py",
                 "torch_failover_elastic.py"):
        with open(os.path.join(ROOT, "examples", name)) as f:
            src = f.read()
        assert not any(bad in src for bad in FORBIDDEN), name


def test_quickstart_on_cpu():
    lines = _run("torch_quickstart.py", "--device", "cpu", "--steps", "4")
    assert lines[-1] == "quickstart OK"
    assert [ln.split()[2] for ln in lines if ln.startswith("train step")] == ["0", "3"]
    slots = [ln for ln in lines if ln.startswith("slot ")]
    assert len(slots) == 2 and all("completed 16" in ln for ln in slots)


def test_serve_collaborative_prints_the_reference_lines():
    got = _run("torch_serve_collaborative.py", "--device", "cpu")
    want = _run("serve_collaborative.py", jax=True)
    assert got[-1].startswith("DTO-EE delay reduction")
    assert got == want


def test_failover_elastic_on_cpu():
    lines = _run("torch_failover_elastic.py", "--device", "cpu")
    assert lines[-1] == "restored-replay max param divergence: 0.00e+00 (bit-exact resume)"
    assert any(ln.startswith("killing stage-2 replica node") for ln in lines)
    assert sum("completed" in ln for ln in lines) == 4


def test_examples_default_to_the_card():
    """Without ``--device`` an example asks for ``cuda``: where there is no
    card it raises before any work."""
    import torch

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                        "torch_serve_collaborative.py")],
                          capture_output=True, text=True, env=env, timeout=600, cwd=ROOT)
    if torch.cuda.is_available():
        assert proc.returncode == 0, proc.stderr[-2000:]
    else:
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr, proc.stderr[-2000:]
        assert proc.stdout == ""
