"""The port's copy of ``repro.perfmodel``: the hardware specs, the
analytical (GenZ-style) cost model, the IVF-PQ retrieval costs, and the
ridge fits of pass runtimes in torch beside the link fit of timed
handoffs."""
