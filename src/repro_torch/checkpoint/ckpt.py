"""Fault-tolerant checkpointing: step-atomic msgpack + manifest (twin of
``repro.checkpoint.ckpt``, in its layout, so either package reads the
other's checkpoints).

Layout:  <dir>/step_<N>/arrays.msgpack  +  <dir>/step_<N>/MANIFEST.json
``arrays.msgpack`` is one msgpack map from each leaf's path (its keys
joined by ``/``, in sorted-key order, as ``jax.tree`` flattens a dict) to
``{"dtype", "shape", "data"}``, the data the array's raw little-endian
bytes; bf16 is ``"bfloat16"`` over its 16-bit patterns. A checkpoint
directory only becomes visible once fully written (tmp-dir rename), so a
mid-save crash never corrupts the restore path. ``restore`` picks the
newest complete step; older steps are garbage-collected with ``keep``
retention.

The msgpack subset this layout uses (map, str, bin, array, unsigned int)
is written and read here in plain Python, with the size classes
``msgpack.packb`` picks, so the bytes equal the JAX package's: the port
needs no msgpack package.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as _tree

# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------

# (fixed-size limit, fix type byte or None, [(limit, type byte, size fmt)])
_STR = (32, 0xA0, [(1 << 8, 0xD9, ">B"), (1 << 16, 0xDA, ">H"),
                   (1 << 32, 0xDB, ">I")])
_BIN = (0, None, [(1 << 8, 0xC4, ">B"), (1 << 16, 0xC5, ">H"),
                  (1 << 32, 0xC6, ">I")])
_ARRAY = (16, 0x90, [(1 << 16, 0xDC, ">H"), (1 << 32, 0xDD, ">I")])
_MAP = (16, 0x80, [(1 << 16, 0xDE, ">H"), (1 << 32, 0xDF, ">I")])
_UINT = [(1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"), (1 << 32, 0xCE, ">I"),
         (1 << 64, 0xCF, ">Q")]


def _header(kind, n: int) -> bytes:
    fix_limit, fix, sized = kind
    if n < fix_limit:
        return bytes([fix | n])
    for limit, code, fmt in sized:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def pack(obj, write):
    """Write ``obj`` (dict, str, bytes or a buffer, list or tuple, int >=
    0) as msgpack through ``write``, as ``msgpack.packb`` encodes it;
    buffers are written as they are, without a copy."""
    if isinstance(obj, dict):
        write(_header(_MAP, len(obj)))
        for k, v in obj.items():
            pack(k, write)
            pack(v, write)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        write(_header(_STR, len(raw)))
        write(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        write(_header(_BIN, n))
        write(obj)
    elif isinstance(obj, (list, tuple)):
        write(_header(_ARRAY, len(obj)))
        for v in obj:
            pack(v, write)
    elif isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        if obj < 128:
            write(bytes([obj]))
            return
        for limit, code, fmt in _UINT:
            if obj < limit:
                write(bytes([code]) + struct.pack(fmt, obj))
                return
        raise ValueError(f"msgpack: int {obj} too large")
    else:
        raise TypeError(f"msgpack subset: cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    out = bytearray()
    pack(obj, out.extend)
    return bytes(out)


def unpackb(buf):
    """Decode one msgpack object of the subset ``pack`` writes from
    ``buf``; bin values come back as memoryviews into ``buf`` (no copy).
    Any other type raises."""
    mv = memoryview(buf)
    obj, end = _unpack(mv, 0)
    if end != len(mv):
        raise ValueError("msgpack: trailing bytes")
    return obj


_SIZED = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_UINTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}


def _unpack(mv: memoryview, i: int):
    c = mv[i]
    i += 1
    if c < 0x80:
        return c, i
    if c <= 0x8F:
        return _items("map", c & 0x0F, mv, i)
    if c <= 0x9F:
        return _items("array", c & 0x0F, mv, i)
    if c <= 0xBF:
        return _items("str", c & 0x1F, mv, i)
    if c in _UINTS:
        fmt = _UINTS[c]
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, mv[i:i + size])[0], i + size
    if c in _SIZED:
        kind, fmt = _SIZED[c]
        size = struct.calcsize(fmt)
        n = struct.unpack(fmt, mv[i:i + size])[0]
        return _items(kind, n, mv, i + size)
    raise ValueError(f"msgpack subset: type byte 0x{c:02x} at {i - 1}")


def _items(kind: str, n: int, mv: memoryview, i: int):
    if kind == "str":
        return str(mv[i:i + n], "utf-8"), i + n
    if kind == "bin":
        return mv[i:i + n], i + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, i = _unpack(mv, i)
            out.append(v)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _unpack(mv, i)
        out[k], i = _unpack(mv, i)
    return out, i


# ---------------------------------------------------------------------------
# arrays
# ---------------------------------------------------------------------------

def _host(t) -> np.ndarray:
    """A leaf as a contiguous host numpy array; bf16 tensors as uint16."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.ascontiguousarray(np.asarray(t))


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).replace("torch.", "")
    return str(np.asarray(t).dtype)


def _pack_array(t) -> Dict:
    a = _host(t)
    return {"dtype": _dtype_name(t), "shape": list(a.shape),
            "data": memoryview(a.reshape(-1).view(np.uint8))}


def _unpack_array(d: Dict, like: torch.Tensor) -> torch.Tensor:
    """The stored array as a tensor of ``like``'s dtype on its device; bf16
    comes back bit for bit."""
    dt, shape = d["dtype"], tuple(d["shape"])
    if dt == "bfloat16":
        raw = np.frombuffer(d["data"], np.uint16).reshape(shape)
        t = torch.from_numpy(raw.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(d["data"], dt).reshape(shape)
                             .copy())
    return t.to(device=like.device, dtype=like.dtype)


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def save(ckpt_dir: str, step: int, state: Any, extra: Optional[Dict] = None,
         keep: int = 3) -> str:
    """Write ``state`` (a nested dict of tensors or arrays) as
    ``<ckpt_dir>/step_<step>`` and keep the newest ``keep`` steps."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _tree.flatten(state)
    payload = {k: _pack_array(v) for k, v in flat.items()}
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        with open(os.path.join(tmp, "arrays.msgpack"), "wb") as f:
            pack(payload, f.write)
        manifest = {"step": step, "n_arrays": len(flat),
                    "bytes": sum(v["data"].nbytes for v in payload.values()),
                    "extra": extra or {}}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic publish
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for d in sorted(os.listdir(ckpt_dir)):
        if not d.startswith("step_"):
            continue
        if os.path.exists(os.path.join(ckpt_dir, d, "MANIFEST.json")):
            best = int(d.split("_")[1])
    return best


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None
            ) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (a nested dict of tensors),
    each leaf on its ``like`` leaf's device in its dtype. Returns (tree,
    manifest)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "arrays.msgpack"), "rb") as f:
        payload = unpackb(f.read())
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    flat_like = _tree.flatten(like)
    missing = [k for k in flat_like if k not in payload]
    if missing:
        raise KeyError(f"checkpoint missing arrays: {missing[:5]}...")
    flat = {k: _unpack_array(payload[k], v) for k, v in flat_like.items()}
    return _tree.unflatten(like, flat), manifest
