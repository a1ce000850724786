"""Output tokens streamed in the window over its seconds (host clock)."""
from bench.window import tokens_in


def read(win):
    return tokens_in(win.served, win.w0, win.w1) / win.seconds
