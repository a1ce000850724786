"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level name; the references import nothing of the program; and
a checkout holding only the benchmark prints no result."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import run

BENCH = Path(__file__).resolve().parents[1]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not set(_imports(path)) & set(run.FORBIDDEN), path


def test_references_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        names = set(_imports(path))
        assert not names & {"repro_torch", "repro", "jax"}, path


def test_forbidden_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert run._loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert run._loaded_forbidden() == ["repro"]


def test_bare_checkout_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "internlm2_20b.chat", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0
    assert not any(line.startswith("{")
                   for line in p.stdout.splitlines())


def test_benchmark_names_files():
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert run.reader(BENCH / "metrics", m["name"]).exists()
    for m in bench["end_to_end"]:
        assert run.reader(BENCH / "e2e", m["name"]).exists()
    for w in bench["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        run.load_cell(w["name"])
    for name in ("run.py",):
        text = (BENCH / name).read_text()
        for w in bench["workloads"]:
            assert w["name"] not in text and w["config"] not in text
    for path in (BENCH / "metrics").glob("*.py"):
        text = path.read_text()
        for w in bench["workloads"]:
            assert w["name"] not in text and w["config"] not in text


def test_reader_of_a_split_name(tmp_path):
    (tmp_path / "decode_pass_ms.py").write_text("")
    (tmp_path / "mfu.batch.py").write_text("")
    assert run.reader(tmp_path, "decode_pass_ms.batch").name == \
        "decode_pass_ms.py"
    assert run.reader(tmp_path, "mfu.batch").name == "mfu.batch.py"
    with pytest.raises(FileNotFoundError):
        run.reader(tmp_path, "mfu")


def test_engine_keywords_are_data():
    """A cell's engine options (a chunked prefill here) come from its
    configuration file alone."""
    from repro_torch.models import transformer
    from bench import weights
    from bench.tests import small
    hf = dict(small.GQA, serve=dict(small.GQA["serve"], engine_kwargs={
        "config": {"chunk_size": 16}, "preemption": "recompute"}))
    cfg = small.port_cfg(hf)
    params = weights.make(transformer.param_shapes(cfg), 1, "cpu")
    eng = run.build_engine(hf, cfg, params, "cpu")
    assert eng.config.chunk_size == 16
    assert eng.preemption == "recompute"
