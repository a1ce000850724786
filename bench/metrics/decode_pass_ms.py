"""Compiled passes (``engine/graphs.py``): mean device ms of a decode
pass's replay in the window (CUDA events)."""
from bench.reduce import decode_pass_ms as read  # noqa: F401
