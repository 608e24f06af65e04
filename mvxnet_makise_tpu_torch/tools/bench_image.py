"""Sub-stage time of the image branch (``PointImageHead``), in the model.

Port of ``mvxnet_makise_tpu/tools/bench_image.py``, the companion of
``tools.bench_branch``.  The fused model at ``Config(use_bf16=True)`` (or
``--config``), seed-0 weights, on ``--batch`` synthetic frames; its head
runs on bfloat16 copies of the weights under ``use_bf16``, as the model
computes.  Rows, in order (``STAGES``):

* ``transform`` (JAX ``:86``): ``models/image_head.detection_transform``
  (normalize, resize to the configuration's min side, pad to 32);
* ``resnet_fpn (incl transform)`` (``:88``): the frozen ResNet50-FPN's
  pyramid (``PointImageHead.pyramid``);
* ``gather`` (``:96``; JAX's ``gather_xla`` and ``gather_fused`` are two
  layouts of this one function): K2, ``ops/gather.fpn_gather``, on the
  precomputed pyramid at the voxel-sorted points;
* ``fusion_mlp`` (``:107``): ``PointImageFusion`` on the gathered rows;
* ``head`` (``:111``; JAX's ``head_raw4``, ``head_xla`` and
  ``head_xla_fused``: the port's ``gather_backend`` selects no other
  code): the whole head, K2 included.

Times and records as in ``tools.bench_micro``, with ``route`` on the rows
that run K2.

Usage: python -m mvxnet_makise_tpu_torch.tools.bench_image
           [--batch N] [--iters N] [--config FILE] [--device cuda|cpu]
"""

from __future__ import annotations

from typing import Iterator

from mvxnet_makise_tpu_torch.tools.profile_components import (
    Row,
    kernel_route,
    make_config,
    print_rows,
    synthetic_batch,
    tool_parser,
)

STAGES = ("transform", "resnet_fpn (incl transform)", "gather",
          "fusion_mlp", "head")


def inputs(cfg, device):
    """What :func:`rows` takes at ``cfg``: the fused model's head with
    seed-0 weights, in bfloat16 under ``use_bf16``, and
    ``cfg.batch_size`` synthetic frames voxelized on ``device``."""
    import torch

    from mvxnet_makise_tpu_torch.models.mvxnet import build_model
    from mvxnet_makise_tpu_torch.train.step import frames_to_batch

    head = build_model(cfg, seed=0, device=device).head
    if cfg.use_bf16:
        head = head.to(torch.bfloat16)
    return head, frames_to_batch(*synthetic_batch(cfg, device), cfg)


def rows(cfg, head, batch) -> Iterator[Row]:
    """The rows of :data:`STAGES`: ``head`` is the model's
    ``PointImageHead`` in the dtype it computes in, ``batch`` the
    voxelized frames (``train/step.frames_to_batch``) on its device."""
    import functools

    from mvxnet_makise_tpu_torch.device import parameter_dtype
    from mvxnet_makise_tpu_torch.models.image_head import (
        detection_transform,
        gather_image_size,
    )
    from mvxnet_makise_tpu_torch.ops.gather import fpn_gather

    dtype = parameter_dtype(head)
    fields = {"dtype": str(dtype).removeprefix("torch.")}
    k2 = {**fields, "route": kernel_route(batch.coords.device)}
    images = batch.images.to(dtype)
    kept = batch.sorted_kept.contiguous()
    rc = batch.sorted_points[..., 4:6].contiguous()
    nv = batch.vmask.sum(dim=1) * cfg.samples_per_voxel - kept.sum(dim=1)
    size = gather_image_size(head.image_size, head.image_min_side)

    yield Row("transform", "transform",
              lambda: detection_transform(images, head.image_min_side),
              fields)
    yield Row("resnet_fpn (incl transform)", "resnet_fpn (incl transform)",
              lambda: head.pyramid(images), fields)
    gather = functools.partial(fpn_gather, head.pyramid(images), rc, kept,
                               size, eps=head.eps,
                               swapped_weights=head.swapped_bilerp)
    yield Row("gather", ("gather_xla", "gather_fused"), gather, k2)
    gathered = gather()
    del gather
    yield Row("fusion_mlp", "fusion_mlp",
              lambda: head.fusion(gathered, kept, nv), fields)
    del gathered
    yield Row("head", ("head_raw4", "head_xla", "head_xla_fused"),
              lambda: head(images, rc, kept, nv), k2)


def main(argv=None) -> int:
    args = tool_parser(iters=10).parse_args(argv)

    from mvxnet_makise_tpu_torch.device import resolve_device, use_full_f32

    device = resolve_device(args.device)
    use_full_f32()
    cfg = make_config(args, batch_size=args.batch)
    print_rows(rows(cfg, *inputs(cfg, device)), device, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
