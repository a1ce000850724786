"""Median of every gap between consecutive streamed tokens that ends in
the window, over all requests (host clock)."""
from bench.window import gaps_ms, percentile


def read(win):
    return percentile(gaps_ms(win.served, win.w0, win.w1), 50)
