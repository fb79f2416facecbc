"""Rule modules self-register on import (see ``core.register``)."""

from repro_torch.analysis.rules import (  # noqa: F401
    determinism,
    exactfloat,
    iteration,
    layering,
    reentrancy,
)
