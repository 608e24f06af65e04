"""Host feed and synthetic frames."""

from mvxnet_makise_tpu_torch.data.pipeline import (  # noqa: F401
    FrameArrays,
    collate,
    preprocess_frame,
)
from mvxnet_makise_tpu_torch.data.synthetic import (  # noqa: F401
    synthetic_frame,
)
