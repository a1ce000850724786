"""Model step (``models/steps.py``): device ms of ``prefill_step`` per
1,000 prompt tokens."""
from bench.reduce import prefill_ms_per_ktok as read  # noqa: F401
