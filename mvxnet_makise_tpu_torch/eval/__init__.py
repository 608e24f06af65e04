"""Prediction decoding."""

from mvxnet_makise_tpu_torch.eval.decode import (  # noqa: F401
    Detections,
    decode_batch,
    decode_predictions,
)
from mvxnet_makise_tpu_torch.eval.ap import (  # noqa: F401
    average_precision_3d,
    evaluate_frames,
)
from mvxnet_makise_tpu_torch.eval.runner import run_eval  # noqa: F401
