"""The port's copy of what it needs from ``repro.perfmodel``: the IVF-PQ
deployment sizes, ``LinkSpec`` and the link fit of timed handoffs. The cost
functions stay in the shared simulator."""
