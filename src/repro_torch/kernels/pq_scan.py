"""CUDA IVF-PQ ADC-scan kernel: the wrapper around ``csrc/pq_scan.cu``.

Replaces the Pallas kernel ``repro.kernels.pq_scan.pq_scan``, the RAG
retrieval hot loop: codes ``(N, M)`` PQ codes, lut ``(M, K)`` fp32
per-subquantizer distances of one query, out ``(N,)`` fp32 with ``out[n] =
sum_m lut[m, codes[n, m]]``. A code outside ``[0, K)`` adds exactly 0, as
in the Pallas kernel (``ref.pq_scan`` says where the JAX reference
differs). Each row is summed m = 0 … M-1 in fp32 by one thread, so the
kernel equals ``ref.pq_scan_in_order`` bit for bit. Codes are uint8, what
an IVF-PQ index stores, or int32, what the JAX wrapper passes. The whole
LUT sits in one block's shared memory, so ``M * K * 4`` bytes may not pass
232,448. The wrapper checks what the kernel takes, launches on PyTorch's
current stream and counts the launch in ``launches``; the C entry plans
the launch itself (``plan`` reports that plan).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build

# shared memory one block may use on an H100 (227 KB): the LUT's limit
SMEM_LIMIT = 232_448
CODE_BYTES = {torch.uint8: 1, torch.int32: 4}
PLAN_FIELDS = ("grid", "threads", "vectors", "lut_bulk", "smem", "batch")

launches = 0          # kernel launches since the last reset
_fn = None


def _entry():
    global _fn
    if _fn is None:
        fn = _build.load("pq_scan").pq_scan_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def plan(codes: torch.Tensor, lut: torch.Tensor,
         lib: ctypes.CDLL = None) -> Dict[str, int]:
    """The launch ``pq_scan`` makes for these inputs, from the C entry
    ``pq_scan_plan`` of ``lib`` (default: the wrapper's build): the grid,
    threads a block, 16-byte vectors a row (0: row by row), whether the LUT
    arrives by bulk copy, the dynamic shared memory and the rows of one
    batch. For logs and tools."""
    fn = (lib or _build.load("pq_scan")).pq_scan_plan
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    (n, m), k = codes.shape, lut.shape[1]
    with _build.launching(codes.device):
        err = fn(n, m, k, CODE_BYTES[codes.dtype],
                 int(codes.data_ptr() % 16 == 0), out)
    _build.check(err, "pq_scan plan")
    return dict(zip(PLAN_FIELDS, out))


def pq_scan(codes, lut) -> torch.Tensor:
    """See the module docstring. Raises ValueError, before building
    anything, on what the kernel does not take."""
    global launches
    if codes.dtype not in CODE_BYTES:
        raise ValueError(f"pq_scan kernel takes uint8 or int32 codes, got "
                         f"{codes.dtype}")
    if lut.dtype != torch.float32:
        raise ValueError(f"pq_scan kernel takes an fp32 lut, got {lut.dtype}")
    if (codes.dim() != 2 or lut.dim() != 2 or lut.shape[0] != codes.shape[1]
            or codes.shape[0] < 1 or lut.numel() < 1):
        raise ValueError(f"pq_scan kernel: unsupported shapes codes="
                         f"{tuple(codes.shape)} lut={tuple(lut.shape)} "
                         f"(needs codes (N, M), lut (M, K), N >= 1)")
    if lut.numel() * 4 > SMEM_LIMIT:
        raise ValueError(f"pq_scan kernel: an (M, K) = {tuple(lut.shape)} "
                         f"fp32 lut is {lut.numel() * 4} bytes, past the "
                         f"{SMEM_LIMIT} of one block's shared memory")
    if not codes.is_contiguous():
        raise ValueError("pq_scan kernel takes contiguous codes")
    if not (codes.is_cuda and lut.device == codes.device):
        raise ValueError("pq_scan kernel: codes and lut must be CUDA tensors "
                         "on one device")
    (n, m), k = codes.shape, lut.shape[1]
    lut = _build.aligned(lut)
    out = torch.empty(n, dtype=torch.float32, device=codes.device)
    with _build.launching(codes.device) as stream:
        err = _entry()(codes.data_ptr(), CODE_BYTES[codes.dtype],
                       lut.data_ptr(), out.data_ptr(), n, m, k, stream)
    _build.check(err, "pq_scan")
    launches += 1
    return out
