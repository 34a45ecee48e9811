"""A tiny cell for the CPU tests: a real cell's configuration and mix cut
to a size the CPU serves in a fraction of a second, with limits of its own
(the numbers scale with the model, so the chip's limits do not carry over:
these come from this size's readings on the CPU, ``test_perfbench_check``
shows them between the program's readings and the control's)."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench.harness import bench  # noqa: E402

# readings at this size over seeds 1-3 (program / fp8 control): token_gap
# 0 / 0-0.22, conf_log_err 0.017-0.035 / 0.19-0.27
TINY_LIMITS = {"token_gap": 0.05, "conf_log_err": 0.1, "missing": 0}


def tiny_cell(cell_name: str, **mix_overrides) -> dict:
    cell = bench.cell(cell_name)
    port = dict(cell["config"]["port"], num_layers=8, d_model=128, num_heads=4, num_kv_heads=2,
                head_dim=32, d_ff=256, vocab_size=512)
    mix = dict(cell["mix"], slot_requests=6,
               prompt={"median": 12, "sigma": 0.6, "min": 4, "max": 24}, batch_size=4,
               check={"max_requests": 4, "tflop": 1}, trace={"seconds": 0.5})
    if mix["gen_len"] > 1:
        mix["gen_len"] = 3
    mix.update(mix_overrides)
    return dict(cell, config={"port": port}, mix=mix, limits=dict(TINY_LIMITS))


def run_tiny(cell: dict, seed: int = 2**31 + 7, control: bool = False) -> dict:
    """One slot of ``cell`` on the CPU, its whole run but the look for a chip."""
    import torch

    from perfbench.harness.runner import run_cell

    torch.set_num_threads(1)
    return run_cell(cell, seed, float("inf"), False, "cpu", 0.0, log=lambda _: None,
                    max_slots=1, control=control)
