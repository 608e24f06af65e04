"""MVXNet-Makise in PyTorch, with hand-written CUDA kernels for Hopper.

A port of ``mvxnet_makise_tpu`` (JAX) that keeps its functions and its
package layout, so each module here has a counterpart of the same name
there.  The JAX package stays the reference the port is tested against;
nothing here imports it, nor JAX.

Subpackages
-----------
config    : the typed ``Config`` (same fields, defaults and validation).
geometry  : calibration matrices and rotated-box geometry.
ops       : voxelizer, column compaction, anchors and target assignment,
            NMS, the dense scatter, and the CUDA kernels: the column merge
            with and without its epilogue, forward and backward
            (``ops/column_merge.py``), the FPN bilinear gather
            (``ops/gather.py``) and the dense voxel scatter, forward and
            backward (``ops/scatter_grid.py``).
models    : blocks, the point-major LiDAR branch, the ResNet50-FPN image
            branch, the fused ``MVXNetPM``, the weight bridge from the
            JAX parameter tree (``models/weights.py``) and the weights to
            and from the reference PyTorch model and torchvision
            (``models/import_reference.py``).
data      : the host feed (C++ crop/project/shuffle/pad) and synthetic
            KITTI-like frames.
eval      : prediction decoding.
train     : the batch layout, loss, optimizer, train step, checkpoints
            and the training loop.
utils     : loss statistics, phase timers and the bench's stage
            watchdogs and supervisor.
tools     : ``python -m mvxnet_makise_tpu_torch.tools.<name>``: train,
            evaluate, detect, cropdata, create_gtdatabase,
            export_checkpoint, gen_experiment, probe and bench.
serve     : ``Detector``, the serving entry point.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel runs its plain PyTorch version.
"""

__version__ = "0.1.0"

from mvxnet_makise_tpu_torch.config import (  # noqa: F401
    Config,
    load_config,
    parse_cli,
)
