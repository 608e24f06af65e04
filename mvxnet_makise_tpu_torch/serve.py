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

A batch of one frame on the card, without autograd and without a mesh,
runs :meth:`Detector.maps`' device work (voxelize, the image branch, VFE,
CML with K1, RPN) as one CUDA graph: the first call at an input shape
runs eagerly, the second captures the graph (span
``mvx.serve.graph_capture``), and every later call copies its frame into
the graph's static inputs and replays it (span ``mvx.serve.graph``).  At
batch 1 the host takes about as long to launch the forward kernel by
kernel as the card takes to run it; a larger batch, a mesh's collectives
and training stay eager.  Decode and NMS always run eagerly.

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


def graph_engages(device: torch.device, mesh, batch: int) -> bool:
    """Whether :meth:`Detector.maps` runs as its replayed CUDA graph: on
    the card, with autograd off, without a mesh (the model axis's
    collectives stay eager), at a batch of one frame.  The profiler spans'
    readers pair each kernel with a kernel launch on the host, which a
    graph's replay does not make, so a larger batch stays eager too."""
    return (device.type == "cuda" and not torch.is_grad_enabled()
            and mesh is None and batch == 1)


class _Graph(NamedTuple):
    """:meth:`Detector.maps`' device work captured at one input key."""
    key: tuple
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple      # static points, num_points, images
    outputs: tuple     # static score and reg maps


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
        # maps' CUDA graph, and the input key of the last eager call that
        # could have been graphed (the next call at that key captures)
        self._graph: Optional[_Graph] = None
        self._graph_key: Optional[tuple] = None

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
        # the graph read the old copies' addresses
        self._graph = None

    def close(self) -> None:
        """Drop the CUDA graph of :meth:`maps` and its memory pool, and
        stop the host-feed thread pool."""
        self._graph = None
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

    def maps(self, points, num_points, images):
        """The model's (score, reg) maps, in its compute dtype, for one
        assembled batch (under a mesh: this data rank's rows, as
        :meth:`run_batch` hands them).  The points keep the masters' dtype
        (float32 under ``use_bf16``): bfloat16 coordinates would move
        points between voxels.  Where :func:`graph_engages`, the second
        call at an input key captures the device work into a CUDA graph
        and later calls replay it; the maps returned are then copies of
        the graph's, which the next replay overwrites."""
        graphed = graph_engages(self.device, self.mesh, len(points))
        with torch.no_grad():
            host = tuple(torch.as_tensor(a)
                         for a in (points, num_points, images))
            if not graphed:
                return self._forward(*self._upload(host))
            key = tuple((tuple(t.shape), t.dtype) for t in host)
            with torch.cuda.device(self.device):
                if self._graph is None or self._graph.key != key:
                    if self._graph_key != key:
                        self._graph_key = key
                        return self._forward(*self._upload(host))
                    self._graph = None      # its pool goes before the next
                    self._graph = self._capture(key, host)
                g = self._graph
                self._upload(host, g.inputs)
                with span("mvx.serve.graph"):
                    g.graph.replay()
                return tuple(m.clone() for m in g.outputs)

    def _upload(self, host, into=None):
        """The batch's points, num_points and images on the card, the
        points and images in the masters' dtype: new tensors, or copied
        into ``into``'s."""
        out = []
        with span("mvx.serve.upload"):
            for i, (t, dtype) in enumerate(zip(host, self._dtypes(host))):
                # a copy from pageable host memory waits for the card
                with sync_point():
                    out.append(t.to(self.device, dtype) if into is None
                               else into[i].copy_(t))
        return out

    def _dtypes(self, host):
        """The dtypes of the uploaded batch: the masters' for the points
        and images, num_points' own."""
        return self.dtype, host[1].dtype, self.dtype

    def _forward(self, points, num_points, images):
        batch = frames_to_batch(points, num_points, images, self.cfg)
        return forward(self.model, batch, self.cfg, self.with_images,
                       self.tensors)

    def _capture(self, key, host) -> _Graph:
        """A CUDA graph of :meth:`_forward` on static inputs shaped as
        ``host`` (zeros here: the device work reads no value on the host,
        so the graph holds for any frame).  As PyTorch's recipe asks, one
        forward runs on a side stream first, so that no library makes its
        lazy state inside the capture."""
        with span("mvx.serve.graph_capture"):
            inputs = tuple(torch.zeros(t.shape, dtype=d, device=self.device)
                           for t, d in zip(host, self._dtypes(host)))
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._forward(*inputs)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outputs = tuple(self._forward(*inputs))
        return _Graph(key, graph, inputs, outputs)

    # -- host API -------------------------------------------------------

    def warm(self, batch_sizes: Sequence[int] = (1,)) -> None:
        """Build the kernels and run two empty batches of each size (the
        second captures :meth:`maps`' CUDA graph where it engages), so
        the first request pays no build or setup cost."""
        cfg = self.cfg
        for b in sorted(set(batch_sizes)):
            for _ in range(2):
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
