"""Training observability."""

from mvxnet_makise_tpu_torch.utils.metrics import (  # noqa: F401
    LossTracker,
    PhaseTimer,
)
from mvxnet_makise_tpu_torch.utils.logging import MetricsLogger  # noqa: F401
from mvxnet_makise_tpu_torch.utils.profiling import (  # noqa: F401
    trace_context,
)
