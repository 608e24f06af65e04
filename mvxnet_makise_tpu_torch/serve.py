"""Serving API: raw frames in, thresholded NMS-filtered 3D boxes out.

Port of ``mvxnet_makise_tpu/serve.py``'s ``Detector``.  The device path
per batch is voxelize -> image branch (ResNet50-FPN, K2 gather, fusion
MLP) -> point-major LiDAR branch (K1 column merge in the CML) -> RPN ->
decode -> rotated NMS (the LiDAR-only detector, ``with_images=False``,
skips the image branch; ``fusion_mode="voxel"`` encodes the voxels from
LiDAR first and gathers one image feature per voxel).  Decode and NMS run
in one pass over the batch (``eval/decode.decode_batch``), and each field
of the batch's detections comes to the host in one copy.  Host work per
frame is the C++ crop+project+shuffle+pad (``data/native.assemble_frame``).
:meth:`Detector.detect_stream` assembles the next batch on a feed thread
while the device runs the current one, and yields each batch's
detections once they are read back.  Under
``cfg.use_bf16`` the model runs on bfloat16 copies of its parameters,
cast once when the detector is made and again by :meth:`Detector.set_params`
(JAX's serving casts them once per weight set too); the points stay
float32.

Each batch that :meth:`Detector.detect_batch`,
:meth:`~Detector.detect_frames` or :meth:`~Detector.detect_stream`
serves is the span ``mvx.serve.batch`` (``utils/profiling``); inside it
``mvx.serve.upload``, ``mvx.model.*``, ``mvx.serve.decode`` (with
``mvx.serve.nms``), ``mvx.serve.readback`` and, under a mesh,
``mvx.serve.gather``.  :meth:`Detector.detect_stream`'s wait for the
feed thread's batch is ``mvx.serve.feed_wait``.

With ``mesh`` (``parallel.make_mesh``, one process per card) the
detector serves data-parallel as JAX's does: every rank passes the same
frames, each data rank runs its contiguous slice of the batch, and every
rank gets the whole batch's detections in frame order (an
``all_gather_object`` over the data ranks); the model axis cuts the large
layers' output channels (``parallel.shard_params``).

PyTorch compiles nothing per batch size, so no request is padded to a
pooled batch size; :meth:`Detector.warm` builds the CUDA kernels and runs
one batch of each size ahead of the first request instead.  Under
``norm_scope="batch"`` the norms pool their statistics over the batch, so
a frame's detections depend on the other frames served with it: JAX's
semantics.  The batch is served as given (JAX pads only to a batch size
it has compiled already, which the port has no need of).

Example:
    det = Detector.create(cfg, checkpoint_epoch=10)   # on the CUDA card
    results = det.detect_frames([(points, calib, image), ...])
    for r in det.detect_stream(frames, batch_size=8): ...
"""

from __future__ import annotations

import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from mvxnet_makise_tpu_torch.config import Config
from mvxnet_makise_tpu_torch.data import native
from mvxnet_makise_tpu_torch.device import (
    DeviceLike,
    parameter_dtype,
    use_deterministic_convolutions,
    use_full_f32,
)
from mvxnet_makise_tpu_torch.eval.decode import (
    Detections,
    FrameDetections,
    decode_batch,
    unpack,
)
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.train import checkpoint as ckpt
from mvxnet_makise_tpu_torch.train.state import cast_for_compute
from mvxnet_makise_tpu_torch.train.step import forward, frames_to_batch
from mvxnet_makise_tpu_torch.utils.profiling import span, sync_point


class Detector:
    """End-to-end detector over batches of raw frames.

    The constructor sets two process-wide switches, under which every
    other model in the process then runs too: TF32 off
    (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``), so the card computes in float32
    like the JAX default, and ``torch.backends.cudnn.deterministic`` on,
    without which the same frames served twice on the card give different
    detections."""

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 with_images: bool = True,
                 score_threshold: float = 0.3,
                 nms_iou_threshold: float = 0.1,
                 pre_max_size: int = 256,
                 post_max_size: int = 64,
                 mesh=None):
        """``mesh``: optional ``('data', 'model')`` DeviceMesh
        (``parallel.make_mesh``) for data-parallel serving; every rank
        builds the detector on the same weights and passes the same
        frames, and a batch must split evenly over the data ranks."""
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            from mvxnet_makise_tpu_torch.parallel.mesh import shard_params

            shard_params(model, mesh)
        self.model = model.eval()
        self.with_images = with_images
        self.device = next(model.parameters()).device
        # the masters' dtype: the points and images arrive in it
        self.dtype = parameter_dtype(model)
        with torch.no_grad():
            self.tensors = cast_for_compute(model, cfg.use_bf16,
                                            with_images)
        use_full_f32()
        use_deterministic_convolutions()
        self.anchors = torch.from_numpy(create_anchors(
            cfg.feature_map_shape, cfg.velo_range,
            cfg.anchor_sizes)).to(self.device)
        self.score_threshold = score_threshold
        self.nms_iou_threshold = nms_iou_threshold
        # NMS candidate-pool bound (eval/decode.py)
        self.pre_max_size = pre_max_size
        self.post_max_size = post_max_size
        self._assemble_pool: Optional[ThreadPoolExecutor] = None

    @classmethod
    def create(cls, cfg: Config,
               checkpoint_epoch: Optional[int] = None,
               state_dict: Optional[Mapping[str, torch.Tensor]] = None,
               seed: int = 0, device: DeviceLike = None,
               with_images: bool = True, mesh=None, **kw) -> "Detector":
        """A detector on ``device`` (default: the CUDA card) with the
        weights of ``state_dict`` (a state dict of the model
        ``models.mvxnet.build_model`` builds for ``cfg``, e.g.
        ``MVXNetPM``'s, or the LiDAR-only ``VoxelNetBranchPM``'s with
        ``with_images=False``) when given;
        else those of epoch ``checkpoint_epoch``'s checkpoint in
        ``cfg.checkpoint_dir`` (``train/checkpoint``), the latest epoch
        there when ``checkpoint_epoch`` is None; else (0, or no
        checkpoint) random weights drawn from ``seed``.  ``mesh``: see
        :meth:`__init__`."""
        if state_dict is None and checkpoint_epoch is None:
            checkpoint_epoch = ckpt.latest_epoch(cfg.checkpoint_dir)
        restore = state_dict is not None or bool(checkpoint_epoch)
        model = build_model(cfg, seed=None if restore else seed,
                            device=device, with_images=with_images)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        elif checkpoint_epoch:
            ckpt.restore_model(cfg.checkpoint_dir, checkpoint_epoch, model)
        return cls(cfg, model, with_images, mesh=mesh, **kw)

    @torch.no_grad()
    def set_params(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Swap in new weights (e.g. a fresh checkpoint): a state dict of
        the detector's model, loaded strictly, and under ``use_bf16`` the
        bfloat16 copies the forward runs on cast again from it.  Under a
        mesh it is the whole model's, and each model rank takes its
        slices of it."""
        self.model.load_state_dict(state_dict, strict=True)
        self.tensors = cast_for_compute(self.model, self.cfg.use_bf16,
                                        self.with_images)

    def close(self) -> None:
        """Stop the host-feed thread pool."""
        if self._assemble_pool is not None:
            self._assemble_pool.shutdown(wait=True)
            self._assemble_pool = None

    # -- device path ----------------------------------------------------

    @torch.no_grad()
    def run_batch(self, points, num_points, images) -> Detections:
        """Detections (on the device) for one assembled batch:
        points (B, P, 6), num_points (B,), images (B, H, W, 3), numpy or
        tensors.  One :class:`Detections` whose fields carry a leading B
        (``eval.decode.decode_batch`` of the float32 maps, as JAX's
        pipeline returns them).  Under a mesh, those of this data rank's
        slice of the batch (:meth:`detect_batch` gathers the whole)."""
        score, reg = self.maps(*self._local(points, num_points, images))
        with span("mvx.serve.decode"):
            return decode_batch(
                score.float(), reg.float(), self.anchors,
                score_threshold=self.score_threshold,
                nms_iou_threshold=self.nms_iou_threshold,
                pre_max_size=self.pre_max_size,
                post_max_size=self.post_max_size)

    def _local(self, points, num_points, images):
        """This data rank's rows of an assembled batch (all of it without
        a mesh); a batch that does not split evenly over the data ranks
        raises ValueError."""
        if self.mesh is None:
            return points, num_points, images
        from mvxnet_makise_tpu_torch.parallel.mesh import (
            axis_size,
            shard_batch,
        )

        n = axis_size(self.mesh, "data")
        if len(points) % n:
            raise ValueError(f"a batch of {len(points)} frames does not "
                             f"split over {n} data ranks")
        return shard_batch((points, num_points, images), self.mesh)

    def _collect(self, det: Detections) -> List[FrameDetections]:
        """Host detections of one batch run by :meth:`run_batch`: under a
        mesh, every data rank's slice gathered in frame order."""
        with span("mvx.serve.readback"):
            out = unpack(det)
        if self.mesh is None:
            return out
        import torch.distributed as dist

        from mvxnet_makise_tpu_torch.parallel.mesh import axis_size

        parts = [None] * axis_size(self.mesh, "data")
        with span("mvx.serve.gather"):
            dist.all_gather_object(parts, out,
                                   group=self.mesh.get_group("data"))
        return [d for part in parts for d in part]

    @torch.no_grad()
    def maps(self, points, num_points, images):
        """The model's (score, reg) maps, in its compute dtype, for one
        assembled batch (under a mesh: this data rank's rows, as
        :meth:`run_batch` hands them).  The points keep the masters' dtype
        (float32 under ``use_bf16``): bfloat16 coordinates would move
        points between voxels."""
        dev = self.device
        with span("mvx.serve.upload"):
            # copies from pageable host memory: each waits for the card
            with sync_point():
                pts = torch.as_tensor(points).to(dev, self.dtype)
            with sync_point():
                nums = torch.as_tensor(num_points).to(dev)
            with sync_point():
                imgs = torch.as_tensor(images).to(dev, self.dtype)
        batch = frames_to_batch(pts, nums, imgs, self.cfg)
        return forward(self.model, batch, self.cfg, self.with_images,
                       self.tensors)

    # -- host API -------------------------------------------------------

    def warm(self, batch_sizes: Sequence[int] = (1,)) -> None:
        """Build the kernels and run one empty batch of each size, so the
        first request pays no build or setup cost."""
        cfg = self.cfg
        for b in sorted(set(batch_sizes)):
            self.run_batch(np.zeros((b, cfg.max_points, 6), np.float32),
                           np.zeros((b,), np.int32),
                           np.zeros((b, *cfg.image_size, 3), np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def assemble(self, frames):
        """Host feed: C++ crop+project+pad per frame into one batch
        ``(points (B, P, 6), num_points (B,), images (B, H, W, 3))`` of
        numpy arrays; frames assemble in parallel on a shared thread
        pool."""
        cfg = self.cfg
        if self._assemble_pool is None and len(frames) > 1:
            n_cpu = os.cpu_count() or 1
            if n_cpu > 1:
                self._assemble_pool = ThreadPoolExecutor(
                    max_workers=min(8, n_cpu),
                    thread_name_prefix="assemble")
        return native.assemble_batch(
            frames, cfg.velo_range, cfg.image_size, cfg.max_points,
            len(frames), pool=self._assemble_pool)

    def detect_batch(self, points, num_points,
                     images) -> List[FrameDetections]:
        """Detections for one batch already assembled by
        :meth:`assemble` (under a mesh, the whole batch's on every
        rank)."""
        with span("mvx.serve.batch"):
            return self._collect(self.run_batch(points, num_points, images))

    def detect_frames(self, frames) -> List[FrameDetections]:
        """frames: list of (points (N, >=4), calib, image or None).
        Points may be raw scans — the native crop+project handles
        range/frustum filtering."""
        return self.detect_batch(*self.assemble(list(frames)))

    def detect_stream(self, frames: Iterable, batch_size: int = 8):
        """Steady-state serving loop: yields one :class:`FrameDetections`
        per input frame, in order, identical to :meth:`detect_frames`.

        ``frames`` is any iterable of (points, calib, image-or-None).
        Batch i+1 is assembled on a feed thread while batch i runs on the
        device, so the host feed and the device overlap; batch i's
        detections are yielded as soon as they are read back, without
        waiting for batch i+1 to run.  The last batch holds what is
        left."""
        it = iter(frames)

        def next_batch():
            buf = list(itertools.islice(it, batch_size))
            return self.assemble(buf) if buf else None

        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="feed") as feed:
            pending = feed.submit(next_batch)
            while True:
                with span("mvx.serve.feed_wait"):
                    batch = pending.result()
                if batch is None:
                    return
                pending = feed.submit(next_batch)
                yield from self.detect_batch(*batch)

    def stream_batches(self, batches: Iterable, batch_size: int):
        """Throughput loop over pre-assembled ``(points, num_points,
        images, n_real)`` batches (numpy arrays or tensors, at most
        ``batch_size`` rows, the first ``n_real`` real): yields ``n_real``
        :class:`FrameDetections` per batch, in order.  Batch i+1 is
        dispatched (uploaded, run and decoded on the device) before batch
        i's detections are read back, as JAX's loop does, so every batch
        waits one batch for its read-back (``tools.bench`` times this
        loop; :meth:`detect_stream` does not defer)."""
        prev = None
        for points, num_points, images, n_real in batches:
            rows = len(points)
            if not 0 < n_real <= rows <= batch_size:
                raise ValueError(
                    f"a batch of {rows} rows with {n_real} real frames "
                    f"does not fit batch_size {batch_size}")
            dets = self.run_batch(points, num_points, images)
            # without a mesh the padding rows are dropped before the read
            # back; under one, after the gather
            if self.mesh is None:
                dets = Detections(*(f[:n_real] for f in dets))
            if prev is not None:
                yield from self._collect(prev[0])[:prev[1]]
            prev = (dets, n_real)
        if prev is not None:
            yield from self._collect(prev[0])[:prev[1]]
