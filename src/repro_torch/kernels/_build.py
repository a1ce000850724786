"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <name>.cu

into ``build/kernels/`` at the repository root (listed in ``.gitignore``).
The decode-shaped attention sources share the ``mma.sync`` helpers of
``csrc/mma_bf16.cuh`` and the decode body of ``csrc/decode_body.cuh``;
``csrc/flash_attention.cu`` (flash attention and, on the same body, the
paged chunk attention of chunked prefill) and
``csrc/flash_attention_bwd.cu`` (its gradient) take their ``wgmma``, TMA,
tensor-map, ``mbarrier``, named-barrier and ``setmaxnreg`` helpers from
``csrc/wgmma_bf16.cuh``, and ``csrc/pq_scan.cu`` its ``mbarrier``
helpers; every entry keeps its one-time shared-memory opt-ins and
occupancy queries per device (``csrc/per_device.cuh``) and is called
under ``launching``. The file name carries a hash of the source, the
shared headers, the flags and any ``-D`` defines (``tools/decode_split.py``
and ``tools/pq_scan_design.py`` build variants that way, into a directory
of their own), so a changed source rebuilds and an unchanged one loads what
is there. ``build_all`` starts one ``nvcc`` per source at
once. Nothing here runs at import time: this module imports on machines
without ``nvcc`` or a card.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("flash_attention", "flash_attention_bwd", "paged_attention",
           "decode_attention", "pq_scan")
HEADERS = ("mma_bf16.cuh", "decode_body.cuh", "wgmma_bf16.cuh",
           "per_device.cuh")
# Tokens per sequence split of the decode body: mirrors DECODE_SPLIT
# (kSplit) in csrc/decode_body.cuh and sizes the decode wrappers' scratch.
DECODE_SPLIT = 64

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report per source and defines (registers, shared
# memory, spills), kept beside each library as <library>.log
ptxas_reports: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build on a machine with the CUDA toolkit")
    return found


def _target(name: str, defines: Sequence[str] = (),
            out_dir: Path = BUILD_DIR) -> Path:
    src = b"".join((CSRC / f).read_bytes() for f in (f"{name}.cu", *HEADERS))
    flags = " ".join([*FLAGS, *defines]).encode()
    h = hashlib.sha256(src + flags).hexdigest()[:16]
    return out_dir / f"{name}-{h}.so"


def build_all(names=SOURCES, defines: Sequence[str] = (),
              out_dir: Path = BUILD_DIR) -> Dict[str, Path]:
    """Compile every missing library into ``out_dir``, one ``nvcc`` per
    source, all started together, with ``defines`` (``-DNAME=value``) added
    to the flags. Raises with the compiler's output if any build fails."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs: List = []
    out: Dict[str, Path] = {}
    for name in names:
        target = _target(name, defines, out_dir)
        out[name] = target
        if target.exists():
            log = target.with_suffix(".log")
            if log.exists():
                ptxas_reports[" ".join((name, *defines))] = log.read_text()
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, *defines, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, target, tmp, proc in procs:
        log, _ = proc.communicate()
        ptxas_reports[" ".join((name, *defines))] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
            continue
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all((name,))[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def decode_scratch(rows: int, cap: int, d: int, device,
                   split: int = DECODE_SPLIT) -> torch.Tensor:
    """fp32 scratch of the decode body's partials: for each of ``rows``
    output rows and each of its ceil(cap / split) splits, the unnormalised
    accumulator (d values), then the (m, l) pair."""
    n = -(-cap // split)
    return torch.empty(rows * n * (d + 2), dtype=torch.float32, device=device)


def check_split(lib: ctypes.CDLL, what: str):
    """Raise unless ``lib`` was built with the split width DECODE_SPLIT."""
    fn = lib.decode_split_tokens
    fn.argtypes, fn.restype = [], ctypes.c_int
    if fn() != DECODE_SPLIT:
        raise RuntimeError(f"{what}: library built with split {fn()}, the "
                           f"wrapper sizes its scratch for {DECODE_SPLIT}")


@contextlib.contextmanager
def launching(device: torch.device):
    """The runtime's current device set to ``device`` around one C call
    (what ``at::cuda::CUDAGuard`` does in an extension): the entries launch
    on the current device and keep their one-time opt-ins per device
    (``csrc/per_device.cuh``). Yields PyTorch's current stream on
    ``device`` as the entries take it."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous with a 16-byte aligned start, as the kernels'
    16-byte vector loads need."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def check(err: int, what: str):
    """Raise on a non-zero CUDA error returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
