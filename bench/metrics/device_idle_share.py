"""Device: share of the traced window with no operation on the card (the
union of the profiler's device intervals, not their sum)."""
from bench.reduce import device_idle_share as read  # noqa: F401
