"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the checkout's root.  The cell (an entry of ``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the run loads both,
builds the kernels the mix uses, makes the weights from the seed on the
card, warms the engine up on the mix's shapes, then serves the mix slot by
slot for ``--seconds`` and prints the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics from a traced span that follows the
window.  After the window the served tokens are checked against the plain
reference; the numbers compared and their limits are the last lines of
standard error and the last key of the result, which is the last line of
standard output.

Exits with 1 and prints no result where the card the cell asks for is not
there, and with 2 where JAX or the JAX package was loaded.
"""
from time import perf_counter

PROCESS_START = perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / ".perfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench.harness import bench
    from perfbench.harness.runner import run_cell

    # the engine's host work (its Python loop, the control plane's small
    # CPU tensors) on one intra-op thread: a thread pool adds hand-off
    # jitter between runs and nothing to tensors this small
    torch.set_num_threads(1)
    cell = bench.cell(args.workload, ROOT)
    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell {args.workload} needs {chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 1
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      PROCESS_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process, and forbidden here: {', '.join(found)}", file=sys.stderr)
        return 2
    for name, v in result["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
