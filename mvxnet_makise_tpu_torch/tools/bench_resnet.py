"""Per-stage time of the frozen ResNet50-FPN extractor.

Port of ``mvxnet_makise_tpu/tools/bench_resnet.py``, the companion of
``tools.bench_image``: the ``resnet_fpn`` stage broken into the stem, the
four trunk stages and the FPN's blocks.  Each row times a truncated
forward, everything up to and including the named stage (``STAGES``):
``stem`` (after the max pool), ``layer1``-``layer4``, ``merge`` (the
top-down sum at level 0), ``fpn0`` (level 0's output block) and ``fpn``
(the whole pyramid); a stage's cost is the difference from the cut
before it (``delta_ms``).

The truncation is the model's own forward, stopped by a hook at the cut
(:func:`truncated`), so it runs the modules of ``ResNetBody`` and ``FPN``
with their parameters and no copy of their code.  ``ResNet50FPN`` gets
seed-0 weights (``models/weights.init_weights``), in bfloat16 under
``use_bf16`` (``Config(use_bf16=True)`` or ``--config``), and runs on
``--batch`` random images of the configuration's size through
``detection_transform`` (416x1344 at the default size and min side),
channels-last as ``models/image_head.fpn_pyramid`` hands them.  Times and
records as in ``tools.bench_micro``, each record with ``delta_ms``.

Usage: python -m mvxnet_makise_tpu_torch.tools.bench_resnet
           [--batch N] [--iters N] [--config FILE] [--device cuda|cpu]
"""

from __future__ import annotations

import json
from typing import Iterator

from mvxnet_makise_tpu_torch.tools.profile_components import (
    Row,
    make_config,
    time_row,
    tool_parser,
)

STAGES = ("stem", "layer1", "layer2", "layer3", "layer4", "merge", "fpn0",
          "fpn")
# where each cut stops the forward: (submodule, after it) — before it,
# the hook returns its input
CUTS = {"stem": ("body.layer1", False), "layer1": ("body.layer1", True),
        "layer2": ("body.layer2", True), "layer3": ("body.layer3", True),
        "layer4": ("body.layer4", True),
        "merge": ("fpn.layer_blocks.0", False),
        "fpn0": ("fpn.layer_blocks.0", True)}


class _Cut(Exception):
    """Raised by a cut's hook to leave the forward with a value."""

    def __init__(self, value):
        super().__init__()
        self.value = value


def _input_cut(module, args):
    raise _Cut(args[0])


def _output_cut(module, args, out):
    raise _Cut(out)


def truncated(net, x, upto: str):
    """``net``'s forward of ``x`` up to and including stage ``upto``: its
    value there (the whole pyramid for "fpn")."""
    if upto == "fpn":
        return net(x)
    name, after = CUTS[upto]
    module = net.get_submodule(name)
    handle = (module.register_forward_hook(_output_cut) if after
              else module.register_forward_pre_hook(_input_cut))
    try:
        net(x)
    except _Cut as cut:
        return cut.value
    finally:
        handle.remove()
    raise RuntimeError(f"the forward never reached {name}")


def rows(net, x) -> Iterator[Row]:
    """The rows of :data:`STAGES` of ``net`` (a ``ResNet50FPN``) on the
    transformed images ``x`` (B, 3, H, W)."""
    from mvxnet_makise_tpu_torch.device import parameter_dtype

    fields = {"dtype": str(parameter_dtype(net)).removeprefix("torch.")}
    for upto in STAGES:
        yield Row(upto, f"upto {upto}",
                  lambda upto=upto: truncated(net, x, upto), fields)


def main(argv=None) -> int:
    args = tool_parser(iters=10).parse_args(argv)

    import numpy as np
    import torch

    from mvxnet_makise_tpu_torch.device import resolve_device, use_full_f32
    from mvxnet_makise_tpu_torch.models.image_head import (
        detection_transform,
    )
    from mvxnet_makise_tpu_torch.models.resnet_fpn import ResNet50FPN
    from mvxnet_makise_tpu_torch.models.weights import init_weights

    device = resolve_device(args.device)
    use_full_f32()
    cfg = make_config(args, batch_size=args.batch)
    dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
    net = ResNet50FPN()
    init_weights(net, torch.Generator().manual_seed(0))
    net = net.to(device=device, dtype=dtype).eval().requires_grad_(False)
    images = np.random.default_rng(0).uniform(
        0, 1, (args.batch, *cfg.image_size, 3))
    x = detection_transform(torch.as_tensor(images, dtype=dtype).to(device),
                            cfg.image_min_side)
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    prev = 0.0
    with torch.no_grad():
        for row in rows(net, x):
            rec = time_row(row, device, args.iters)
            rec["delta_ms"] = rec["ms_per_batch"] - prev
            prev = rec["ms_per_batch"]
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
