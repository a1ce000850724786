"""90th percentile over every request due in the window of its first
token's time less its due time, censored at the run's end (host clock)."""
from bench.window import percentile, ttfts_ms


def read(win):
    return percentile(ttfts_ms(win.served, win.w0, win.w1, win.end), 90)
