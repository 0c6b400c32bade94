"""Runtime sanitizers of the port (the JAX package's ``analysis/``, its
``guards`` half): a recompile fence over CUDA-graph captures and kernel
builds, a transfer guard over the fenced dispatch's inputs, and a
NaN/inf fence on the loss. ``TrainConfig.sanitize`` and the
``JG_SANITIZE`` environment variable arm them.
"""

from .guards import (
    NaNFenceError,
    RecompileFenceError,
    Sanitizer,
    SanitizerConfig,
    SanitizerError,
    TransferGuardError,
)

__all__ = [
    "NaNFenceError",
    "RecompileFenceError",
    "Sanitizer",
    "SanitizerConfig",
    "SanitizerError",
    "TransferGuardError",
]
