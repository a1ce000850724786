"""Run one cell of ``BENCHMARK.json`` once:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``bench/configs/<config>.json``: the
published config, the engine's sizes under ``serve``, the reference family
and the limits of ``correct``) and a traffic mix (``bench/traffic/<mix>.json``).
Set-up makes the weights on the card from the seed, builds the engine the
program's ``make_engine`` gives, warms it up with the longest prompt of the
mix, and generates the requests; then ``drive.drive`` serves them open loop for
the mix's ramp and ``--seconds`` of window. ``--trace 0`` prints the cell's
end-to-end metrics (``bench/e2e/<metric>.py``), ``--trace 1`` its per-layer
metrics (``bench/metrics/<metric>.py``) from a run with wrappers and the
profiler. Both then judge a sample of finished requests against the
family's fp32 reference (``bench/check.py``) and print the compared numbers
with their limits, last on stderr and last in the result line.

Without a CUDA card, or with fewer cards than the cell asks for, or if
``jax``, ``jaxlib``, ``flax`` or ``repro`` was loaded, it prints no result
and exits non-zero. Kernels build into ``build/`` inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, List, Tuple  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench import check, drive, traffic, weights, work  # noqa: E402
from bench import devtrace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_S = 3.0


@dataclass
class Cell:
    """One cell with everything its names lead to."""
    name: str
    chips: int
    hf: dict
    mix: dict
    ref: object
    e2e: List[Tuple[str, str, Callable]] = field(default_factory=list)
    per_layer: List[Tuple[str, str, Callable]] = field(default_factory=list)


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(folder: Path, name: str) -> Path:
    """The file that reads metric ``name``: ``<folder>/<name>.py``, or, for
    a name split by cell (``decode_pass_ms.batch``), the file of the name
    without its last dotted parts, so that one reduction keeps one file."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = folder / (".".join(parts[:n]) + ".py")
        if path.exists():
            return path
    raise FileNotFoundError(folder / f"{name}.py")


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """A metric with ``workloads`` is the listed cells'; an end-to-end one
    without is every cell's, a per-layer one every cell's that reports
    the metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_of_cell


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = next(x for x in bench["workloads"] if x["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    hf = json.loads((root / conf["file"]).read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(
        name=name, chips=w["chips"], hf=hf,
        mix=traffic.load(w["traffic"]),
        ref=importlib.import_module(f"bench.reference.{hf['reference']}"),
        e2e=[(m["name"], m["unit"], _load(reader(BENCH / "e2e", m["name"]))
              .read) for m in e2e],
        per_layer=[(m["name"], m["unit"],
                    _load(reader(BENCH / "metrics", m["name"])).read)
                   for m in per])


def port_config(hf: dict, cfg=None):
    """The port's config of ``hf["serve"]["arch"]`` (or ``cfg``) with the
    deployment's choices of ``hf["serve"]["port"]`` (dotted field ->
    value) applied."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = cfg or get_config(hf["serve"]["arch"])
    for path, value in hf["serve"].get("port", {}).items():
        *outer, last = path.split(".")
        if outer:
            inner = getattr(cfg, outer[0])
            cfg = dataclasses.replace(cfg, **{outer[0]: dataclasses.replace(
                inner, **{last: value})})
        else:
            cfg = dataclasses.replace(cfg, **{last: value})
    return cfg


def check_port_config(cfg, fields: dict):
    """Refuse a port config whose sizes are not the file's."""
    for path, want in fields.items():
        got = cfg
        for k in path.split("."):
            got = getattr(got, k)
        if got != want:
            raise ValueError(f"the port's {cfg.name} has {path}={got!r}, "
                             f"the configuration file {want!r}")


def build_engine(hf: dict, cfg, params, device):
    """The engine ``make_engine`` gives for ``cfg``, with the sizes of
    ``hf["serve"]`` (``max_batch``, ``max_len``, ``block_tokens``) and any
    further keywords of ``make_engine`` under ``serve["engine_kwargs"]``;
    a ``config`` there is the paged engine's ``EngineConfig`` as a dict
    (``{"chunk_size": 512}``)."""
    from repro_torch.engine.core import EngineConfig, make_engine
    serve = hf["serve"]
    kw = dict(serve.get("engine_kwargs", {}))
    if "config" in kw:
        kw["config"] = EngineConfig(**kw["config"])
    return make_engine(cfg, params=params, max_batch=serve["max_batch"],
                       max_len=serve["max_len"],
                       block_tokens=serve.get("block_tokens", 16),
                       device=device, **kw)


class Window:
    """What the end-to-end metrics read."""

    def __init__(self, served, w0, w1, end, seconds, setup_s):
        self.served, self.w0, self.w1, self.end = served, w0, w1, end
        self.seconds, self.setup_s = seconds, setup_s


def _loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _power_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def warm_up(eng, prompt_len: int, vocab: int):
    """One request of ``prompt_len`` random tokens and two outputs through
    the engine: builds and loads the kernels, replays the decode pass and
    sizes the allocator for the mix's longest prompt."""
    rng = np.random.default_rng(12345)
    eng.submit(rng.integers(0, vocab, prompt_len).astype(np.int32), 2)
    while eng.waiting or any(a is not None for a in eng.active):
        eng.run(max_steps=eng.steps + 1)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", port_cfg=None) -> dict:
    """One run of ``cell``: the result line as a dict."""
    from repro_torch.models import transformer

    device = torch.device(device)
    hf, mix = cell.hf, cell.mix
    cfg = port_config(hf, port_cfg)
    check_port_config(cfg, cell.ref.port_fields(hf))
    params = weights.make(transformer.param_shapes(cfg), seed, device,
                          getattr(torch, cfg.param_dtype))
    eng = build_engine(hf, cfg, params, device)
    horizon = mix["ramp_s"] + seconds + mix["drain_s"]
    reqs = traffic.generate(mix, seed, horizon, hf["vocab_size"])
    warm_up(eng, max(len(r.prompt) for r in reqs), hf["vocab_size"])
    rec = None
    if trace:
        rec = drive.Records(shapes=cell.ref.work(hf), seconds=seconds)
        if device.type == "cuda":
            rec.peak = work.peaks(torch.cuda.get_device_name(device))
            devtrace.warm(device)
            rec.names = {k: devtrace.kernel_names(fn) for k, fn in
                         cell.ref.isolated_kernels(hf, device).items()}
            print(f"card: {_power_line()}", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.synchronize()
    served, start, w0, w1, end = drive.drive(
        eng, reqs, mix["ramp_s"], seconds, mix["drain_s"], device, rec,
        TRACE_S if trace else 0.0)
    setup_s = start - T_START
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    win = Window(served, w0, w1, end, seconds, setup_s)
    if trace:
        rec.window = win
        metrics = {n: read(rec) for n, _, read in cell.per_layer}
        units = {n: u for n, u, _ in cell.per_layer}
    else:
        metrics = {n: read(win) for n, _, read in cell.e2e}
        units = {n: u for n, u, _ in cell.e2e}
    metrics = {n: {"value": v, "unit": units[n]}
               for n, v in metrics.items() if v is not None}
    finished = [s.req for s in served
                if s.req is not None and s.req.finish_time is not None]
    refused = sum(s.refused for s in served)
    del eng
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check.judge(cell.ref, hf, params,
                         check.sample(finished, seed, mix["check"]),
                         hf["limits"])
    checks["refused"] = {"value": refused, "limit": 0}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": check.passed(checks), "attempted": len(served),
           "failed": refused, "metrics": metrics, "device": dev}
    if rec is not None and rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.top_ops(10),
                            "idle_gaps": rec.trace.idle_gaps(10)}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = _loaded_forbidden()
    if bad:
        print(f"loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
