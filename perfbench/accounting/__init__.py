"""The yardstick's arithmetic: operations and bytes that the work needs,
from the configuration and the inputs alone, and the chip's peaks."""

import json
import os

with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as _f:
    PEAKS = json.load(_f)


def peak_flop_per_s(dtype) -> float:
    """The card's dense peak in the precision a configuration computes in
    (a ``torch.dtype``): bfloat16's, or float32's without TF32."""
    return PEAKS["bf16_flop_per_s" if str(dtype) == "torch.bfloat16"
                 else "f32_flop_per_s"]
