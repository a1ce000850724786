"""Engine (``engine/core.py``): host ms of each iteration in the window outside
prefill and the decode pass (both bracketed by synchronisation)."""
from bench.reduce import host_ms_per_iter as read  # noqa: F401
