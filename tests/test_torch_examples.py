"""The port's twins of ``examples/rag_pipeline.py`` and
``examples/batching_study.py`` print what the JAX examples print: each
JAX example's ``main()`` and its twin's ``main`` (the RAG twin's with
``["--device", "cpu"]``; the batching study takes no device) run with
stdout captured, compared text for text (the simulator's lines, and the
live scan's top-5 ids, which the twin takes from the plain ``pq_scan`` on
the CPU)."""
import contextlib
import importlib.util
import io
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return buf.getvalue(), out


@pytest.mark.parametrize("name, argv", [
    ("rag_pipeline", (["--device", "cpu"],)), ("batching_study", ())])
def test_twin_prints_what_the_jax_example_prints(name, argv):
    want, _ = _printed(_load(name).main)
    got, _ = _printed(_load(f"{name}_torch").main, *argv)
    assert got.splitlines() == want.splitlines()


def test_rag_twin_returns_its_top5_and_distances():
    """The ids it prints are the 5 smallest of the distances it returns,
    nearest first, and the scan covers every row."""
    got, (ids, dist) = _printed(_load("rag_pipeline_torch").main,
                                ["--device", "cpu"])
    assert f"top-5 ids={ids}" in got
    assert dist.shape == (200_000,) and dist.device.type == "cpu"
    assert ids == dist.argsort(stable=True)[:5].tolist()
