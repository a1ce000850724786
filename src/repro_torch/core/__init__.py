"""The port's copy of ``repro.core``, the HERMES simulator: a
heterogeneous multi-stage LLM inference simulator (coordinator, clients,
schedulers, batching, memory hierarchy, comm model, workloads, metrics,
fault handling), so that the port imports nothing of ``repro``.

The event loop stays plain Python over numpy's seeded generators, drawing
the numbers the reference draws; torch enters only where the reference
used JAX, the regression pricing of ``ClientPerf(use_regression=True)``,
whose ridge fits live on an explicit ``device`` (default the card)."""
from repro_torch.core.autoscaler import (  # noqa: F401
    Autoscaler, AutoscalerConfig, ClientTemplate, Observation,
    TargetTrackingPolicy, ThresholdHysteresisPolicy, make_policy)
from repro_torch.core.coordinator import (  # noqa: F401
    Coordinator, CoordinatorConfig)
from repro_torch.core.metrics import SLO, MetricsCollector  # noqa: F401
from repro_torch.core.system import SystemSpec, build_system  # noqa: F401
from repro_torch.core.workload import (  # noqa: F401
    AZURE_CODE, AZURE_CONV, WorkloadConfig, generate)
