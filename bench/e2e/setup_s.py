"""Process start to the first due request: imports, weights, the engine
(its passes' warm-up and capture), kernel builds, the warm-up request and
the traffic (host clock)."""


def read(win):
    return win.setup_s
