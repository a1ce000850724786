"""99th percentile of the gaps of ``itl_p50_ms``: the stall a blocking
prefill puts on the running rows (host clock)."""
from bench.window import gaps_ms, percentile


def read(win):
    return percentile(gaps_ms(win.served, win.w0, win.w1), 99)
