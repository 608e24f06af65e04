"""MVXNet-Makise in PyTorch, with hand-written CUDA kernels for Hopper.

A port of ``mvxnet_makise_tpu`` (JAX) that keeps its functions and its
package layout, so each module here has a counterpart of the same name
there.  The JAX package stays the reference the port is tested against;
nothing here imports it, nor JAX.

Subpackages
-----------
config    : the typed ``Config`` (same fields, defaults and validation).
geometry  : calibration matrices and rotated-box geometry.
ops       : voxelizer, column compaction, anchors, NMS, and the two CUDA
            kernels: the fused column merge (``ops/column_merge.py``) and
            the FPN bilinear gather (``ops/gather.py``).
models    : blocks, the point-major LiDAR branch, the ResNet50-FPN image
            branch, the fused ``MVXNetPM`` and the weight bridge from the
            JAX parameter tree (``models/weights.py``).
data      : the host feed (C++ crop/project/shuffle/pad) and synthetic
            KITTI-like frames.
eval      : prediction decoding.
train     : the batch layout the model consumes.
serve     : ``Detector``, the serving entry point.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel runs its plain PyTorch version.
"""
