"""Serving API: raw frames in, thresholded NMS-filtered 3D boxes out.

Port of ``mvxnet_makise_tpu/serve.py``'s ``Detector``.  The device path
per batch is voxelize -> image branch (ResNet50-FPN, K2 gather, fusion
MLP) -> point-major LiDAR branch (K1 column merge in the CML) -> RPN ->
decode -> rotated NMS (the LiDAR-only detector, ``with_images=False``,
skips the image branch).  Host work per frame is the C++
crop+project+shuffle+pad (``data/native.assemble_frame``).  Under
``cfg.use_bf16`` the model runs on bfloat16 copies of its parameters,
cast once when the detector is made and again by :meth:`Detector.set_params`
(JAX's serving casts them once per weight set too); the points stay
float32.

PyTorch compiles nothing per batch size, so no request is padded to a
pooled batch size; :meth:`Detector.warm` builds the CUDA kernels and runs
one batch of each size ahead of the first request instead.

Example:
    det = Detector.create(cfg, checkpoint_epoch=10)   # on the CUDA card
    results = det.detect_frames([(points, calib, image), ...])
    for r in det.detect_stream(frames, batch_size=8): ...
"""

from __future__ import annotations

import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Mapping, NamedTuple, Optional, Sequence

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
    decode_predictions,
)
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.ops.assign import create_anchors
from mvxnet_makise_tpu_torch.train import checkpoint as ckpt
from mvxnet_makise_tpu_torch.train.state import cast_for_compute
from mvxnet_makise_tpu_torch.train.step import forward, frames_to_batch


class FrameDetections(NamedTuple):
    boxes: np.ndarray     # (K, 7) xyzlwhr (LiDAR frame)
    scores: np.ndarray    # (K,)
    classes: np.ndarray   # (K,) int — index into cfg.target_classes


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
                 post_max_size: int = 64):
        self.cfg = cfg
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
               with_images: bool = True, **kw) -> "Detector":
        """A detector on ``device`` (default: the CUDA card) with the
        weights of ``state_dict`` (an ``MVXNetPM`` state dict, or the
        LiDAR-only ``VoxelNetBranchPM``'s with ``with_images=False``) when
        given;
        else those of epoch ``checkpoint_epoch``'s checkpoint in
        ``cfg.checkpoint_dir`` (``train/checkpoint``), the latest epoch
        there when ``checkpoint_epoch`` is None; else (0, or no
        checkpoint) random weights drawn from ``seed``."""
        if state_dict is None and checkpoint_epoch is None:
            checkpoint_epoch = ckpt.latest_epoch(cfg.checkpoint_dir)
        restore = state_dict is not None or bool(checkpoint_epoch)
        model = build_model(cfg, seed=None if restore else seed,
                            device=device, with_images=with_images)
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        elif checkpoint_epoch:
            ckpt.restore_model(cfg.checkpoint_dir, checkpoint_epoch, model)
        return cls(cfg, model, with_images, **kw)

    @torch.no_grad()
    def set_params(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Swap in new weights (e.g. a fresh checkpoint): a state dict of
        the detector's model, loaded strictly, and under ``use_bf16`` the
        bfloat16 copies the forward runs on cast again from it."""
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
    def run_batch(self, points, num_points, images) -> List[Detections]:
        """Detections (on the device) for one assembled batch:
        points (B, P, 6), num_points (B,), images (B, H, W, 3), numpy or
        tensors."""
        score, reg = self.maps(points, num_points, images)
        return [decode_predictions(
            s.float(), r.float(), self.anchors,
            score_threshold=self.score_threshold,
            nms_iou_threshold=self.nms_iou_threshold,
            pre_max_size=self.pre_max_size,
            post_max_size=self.post_max_size)
            for s, r in zip(score, reg)]

    @torch.no_grad()
    def maps(self, points, num_points, images):
        """The model's (score, reg) maps, in its compute dtype, for one
        assembled batch.  The points keep the masters' dtype (float32
        under ``use_bf16``): bfloat16 coordinates would move points
        between voxels."""
        dev = self.device
        pts = torch.as_tensor(points).to(dev, self.dtype)
        nums = torch.as_tensor(num_points).to(dev)
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

    @staticmethod
    def _unpack(dets: Sequence[Detections]) -> List[FrameDetections]:
        out = []
        for d in dets:
            v = d.valid.cpu().numpy()
            out.append(FrameDetections(
                boxes=d.boxes.cpu().numpy()[v],
                scores=d.scores.cpu().numpy()[v],
                classes=d.classes.cpu().numpy()[v]))
        return out

    def detect_batch(self, points, num_points,
                     images) -> List[FrameDetections]:
        """Detections for one batch already assembled by
        :meth:`assemble`."""
        return self._unpack(self.run_batch(points, num_points, images))

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
        device (:meth:`stream_batches`), so host and device work
        overlap; the last batch holds what is left."""
        def assembled():
            it = iter(frames)

            def next_batch():
                buf = list(itertools.islice(it, batch_size))
                return (*self.assemble(buf), len(buf)) if buf else None

            with ThreadPoolExecutor(max_workers=1,
                                    thread_name_prefix="feed") as feed:
                pending = feed.submit(next_batch)
                while True:
                    batch = pending.result()
                    if batch is None:
                        return
                    pending = feed.submit(next_batch)
                    yield batch

        yield from self.stream_batches(assembled(), batch_size)

    def stream_batches(self, batches: Iterable, batch_size: int):
        """The core of :meth:`detect_stream`: consumes pre-assembled
        ``(points, num_points, images, n_real)`` batches (numpy arrays or
        tensors, at most ``batch_size`` rows, the first ``n_real`` real)
        and yields ``n_real`` :class:`FrameDetections` per batch, in order.
        Batch i+1 is dispatched (uploaded, run and decoded on the device)
        before batch i's detections are read back."""
        prev = None
        for points, num_points, images, n_real in batches:
            rows = len(points)
            if not 0 < n_real <= rows <= batch_size:
                raise ValueError(
                    f"a batch of {rows} rows with {n_real} real frames "
                    f"does not fit batch_size {batch_size}")
            cur = self.run_batch(points, num_points, images)[:n_real]
            if prev is not None:
                yield from self._unpack(prev)
            prev = cur
        if prev is not None:
            yield from self._unpack(prev)
