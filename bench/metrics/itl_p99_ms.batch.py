"""Model step (``models/steps.py``): 99th percentile of the gaps between
streamed tokens in the traced run, above capacity: the stall the
blocking prefills of turnover put on every row."""
from bench.reduce import itl_ms


def read(rec):
    return itl_ms(rec, 99)
