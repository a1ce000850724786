"""The port's copy of what it needs from ``repro.perfmodel``: the IVF-PQ
deployment sizes. The cost functions stay in the shared simulator."""
