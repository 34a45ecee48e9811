"""BENCHMARK.json and the files it names: every piece found by name, every
name and unit of the allowed characters, the imports each module may make."""
from __future__ import annotations

import ast
import re

import pytest
from perfbench_tiny import ROOT

from perfbench.harness import bench

BENCH = bench.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_every_piece_of_a_cell_is_found_by_name(name):
    cell = bench.cell(name)
    assert cell["config"]["port"]["name"] == cell["entry"]["config"]
    assert cell["mix"]["name"] == cell["entry"]["traffic"]
    assert set(cell["limits"]) >= {"token_gap", "conf_log_err", "missing"}
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_every_metric_has_a_reader_and_every_reader_a_metric():
    files = set((bench.PERFBENCH / "metrics").glob("*.py"))
    used = {bench.reader_path(m["name"]) for m in METRICS}
    assert files == used


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    moves = {m["name"] for m in BENCH["end_to_end"]}
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["moves"] in moves and "\n" not in m["layer"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_config_files_agree_with_the_published_widths():
    for c in BENCH["configs"]:
        f = bench.load_json(ROOT / c["file"])
        p = f["port"]
        width = f.get("hidden_size")
        assert p["d_model"] == width
        assert p["d_ff"] == f.get("intermediate_size", f.get("ffn_hidden_size"))
        assert p["vocab_size"] == f.get("vocab_size", f.get("padded_vocab_size"))
        assert p["num_layers"] == f.get("num_hidden_layers", f.get("num_layers"))
        assert p["num_heads"] == f["num_attention_heads"]
        assert set(c["reduced"]) == set(f["reduced"]) <= set(f["departures"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


MODULES = sorted(p for p in bench.PERFBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=[str(p.relative_to(ROOT)) for p in MODULES])
def test_no_module_imports_jax_or_the_jax_package(path):
    """Top-level names compared whole: ``repro_torch`` is not ``repro``.  The
    reference imports nothing of the program either."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    if "reference" in path.relative_to(bench.PERFBENCH).parts:
        banned.add("repro_torch")
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & banned, (path, tops & banned)
