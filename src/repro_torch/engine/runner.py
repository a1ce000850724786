"""Serving-engine facade: the public names of ``engine/core.py`` under the
import path the JAX package uses (``repro.engine.runner``)."""
from repro_torch.engine.core import (      # noqa: F401
    Engine,
    EngineConfig,
    EngineCore,
    EngineRequest,
    make_engine,
    paged_supported,
)

__all__ = [
    "Engine",
    "EngineConfig",
    "EngineCore",
    "EngineRequest",
    "make_engine",
    "paged_supported",
]
