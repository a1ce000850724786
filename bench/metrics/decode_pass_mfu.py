"""Whole decode step: model FLOPs of the window's decode passes (2 x the
weights a row multiplies, and attention over each row's context) over
their device time x the card's bf16 peak."""
from bench.reduce import decode_pass_mfu as read  # noqa: F401
