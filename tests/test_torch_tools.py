"""PyTorch port: the training loop with the GT database and in-loop AP,
and the dataset tools, end to end on the CPU at a small configuration.

A synthetic KITTI tree (``data.synthetic.write_kitti_tree``, 64x96
images) goes through ``tools.cropdata`` -> ``tools.create_gtdatabase`` ->
``tools.train`` (paste augmentation, val AP) -> ``tools.evaluate`` (the
loop's AP again from the checkpoint) -> ``tools.detect`` (KITTI result
files).  Also: the feed gives the same run for 1 and 4 workers,
``Detector.create`` restores a checkpoint (the latest by default), the
KITTI result line equals the JAX CLI's formatting of the same box, and
every tool defaults to the card and raises without one.
"""

import os
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvxnet_makise_tpu.geometry.boxes import (
    boxes3d_to_corners3d as jax_corners3d,
)
from mvxnet_makise_tpu.geometry.boxes import (
    boxes_lidar_to_cam as jax_lidar_to_cam,
)
from mvxnet_makise_tpu.geometry.calib import Calib as JaxCalib
from mvxnet_makise_tpu.geometry.calib import lidar_to_image as jax_to_image
from mvxnet_makise_tpu_torch.config import load_config
from mvxnet_makise_tpu_torch.data.gt_database import load_database
from mvxnet_makise_tpu_torch.data.kitti import load_dataset
from mvxnet_makise_tpu_torch.data.synthetic import toy_calib, write_kitti_tree
from mvxnet_makise_tpu_torch.models.import_reference import (
    export_reference_checkpoint,
)
from mvxnet_makise_tpu_torch.models.mvxnet import build_model
from mvxnet_makise_tpu_torch.models.resnet_fpn import (
    load_torchvision_fpn_weights,
)
from mvxnet_makise_tpu_torch.serve import Detector
from mvxnet_makise_tpu_torch.tools import (
    create_gtdatabase,
    cropdata,
    detect,
    evaluate,
)
from mvxnet_makise_tpu_torch.tools import train as train_cli
from mvxnet_makise_tpu_torch.train import checkpoint as ckpt
from mvxnet_makise_tpu_torch.train.loop import train
from mvxnet_makise_tpu_torch.train.state import TrainState

KW = dict(velo_range=(0.0, -8.0, -3.0, 12.8, 8.0, 1.0),
          voxel_shape=(32, 40, 10), image_size=(64, 96), max_points=1024,
          max_voxels=256, max_boxes=8, samples_per_voxel=8, assign_window=6,
          image_min_side=0, batch_size=2, num_workers=2)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and each would otherwise start one thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _yaml(path, **extra):
    with open(path, "w") as f:
        for k, v in dict(KW, **extra).items():
            f.write(f"{k}: {list(v) if isinstance(v, tuple) else v}\n")
    return str(path)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A cropped tree (4 train, 2 val frames) with its GT database."""
    work = tmp_path_factory.mktemp("kitti")
    root = str(work / "kitti")
    cfg_path = _yaml(work / "tiny.yaml")
    write_kitti_tree(root, load_config(cfg_path), np.random.default_rng(0),
                     4, 2, num_cars=3, num_points=1500)
    assert cropdata.main([root, "native", "--config", cfg_path,
                          "--device", "cpu"]) == 0
    assert create_gtdatabase.main([root, "--classes", "Car", "--config",
                                   cfg_path, "--device", "cpu"]) == 0
    return root, cfg_path


def test_loop_with_gt_database_and_eval_for_any_number_of_workers(
        tree, tmp_path, capsys):
    """The loop with the paste augmentation on 1 and 4 feed threads: the
    same losses and weights; with the val frames, the AP line and the
    phase times; a checkpoint per run."""
    root, cfg_path = tree
    db = load_database(root, ["Car"])
    assert len(db["Car"]) > 0
    runs = []
    for workers, eval_frames in ((1, None), (4, "val")):
        cfg = load_config(cfg_path,
                          checkpoint_dir=str(tmp_path / f"w{workers}"))
        state = train(cfg, load_dataset(root, "train", cfg), gt_db=db,
                      workers=workers, num_epochs=1, log_every=1,
                      eval_frames=eval_frames and load_dataset(
                          root, eval_frames, cfg), device="cpu")
        out = capsys.readouterr().out
        assert state.step == 2
        assert os.path.exists(tmp_path / f"w{workers}" / "epoch1")
        losses = [ln.split(": ", 1)[1] for ln in out.splitlines()
                  if " it " in ln]
        runs.append((losses, state.model.state_dict()))
    assert re.search(r"epoch 1 val Car: AP=\d\.\d{4} R=\d\.\d{4} gt=6", out)
    assert "host_prep" in out and "host_wait" in out and "eval" in out
    assert len(runs[0][0]) == 2 and runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def _values(line):
    return dict(re.findall(r"(AP|R|gt)=([\d.]+)", line))


def test_tools_chain_on_the_cpu(tree, tmp_path, capsys):
    """cropdata's three modes, then train -> evaluate -> detect."""
    root = str(tmp_path / "kitti")
    shutil.copytree(tree[0], root)
    cfg_path = _yaml(tmp_path / "tiny.yaml",
                     checkpoint_dir=str(tmp_path / "ck"))
    crop_dir = os.path.join(root, "training", "velodyne_croped")
    crops = {}
    for mode in cropdata.MODES:
        assert cropdata.main([root, mode, "--config", cfg_path,
                              "--device", "cpu"]) == 0
        crops[mode] = {}
        for name in sorted(os.listdir(crop_dir)):
            with open(os.path.join(crop_dir, name), "rb") as f:
                crops[mode][name] = f.read()
    assert crops["native"] == crops["numpy"] == crops["torch"]

    dev = ["--config", cfg_path, "--device", "cpu"]
    assert train_cli.main([root, "-n", "1", "--eval-every", "1", *dev]) == 0
    loop_line = [ln for ln in capsys.readouterr().out.splitlines()
                 if " val Car: " in ln]
    assert len(loop_line) == 1
    assert evaluate.main([root, "-r", "1", *dev]) == 0
    out = capsys.readouterr().out
    assert "restored epoch 1" in out
    all_line = [ln for ln in out.splitlines() if ln.startswith("Car all:")]
    assert _values(all_line[0]) == _values(loop_line[0])

    results = str(tmp_path / "results")
    assert detect.main([root, "-o", results, "-r", "1", "--batch", "2",
                        "--score-threshold", "0.0", *dev]) == 0
    assert sorted(os.listdir(results)) == ["000004.txt", "000005.txt"]
    for name in os.listdir(results):
        with open(os.path.join(results, name)) as f:
            lines = [ln.split() for ln in f.read().splitlines()]
        assert lines
        for parts in lines:
            assert len(parts) == 16 and parts[0] == "Car"
            assert np.isfinite(np.asarray(parts[1:], np.float64)).all()


def _torchvision_file(path, seed):
    """A fabricated torchvision Faster R-CNN ResNet50-FPN state dict with
    the real key layout (``backbone.body...``, ``backbone.fpn...``, BN
    statistics and the unused fourth FPN output block, plus an
    ``rpn.head`` key the extractor does not take), saved to ``path``: a
    seeded model's extractor in the reference layout, its BatchNorm
    statistics random."""
    ref = export_reference_checkpoint(build_model(
        load_config(None, **KW), seed=seed, device="cpu").state_dict())
    gen = torch.Generator().manual_seed(seed)
    tv = {}
    for k, v in ref.items():
        if not k.startswith("head.extractor.backbone."):
            continue
        if k.endswith(("running_mean", "bias")):
            v = 0.1 * torch.randn(v.shape, generator=gen)
        elif k.endswith(("running_var", "bn1.weight", "bn2.weight",
                         "bn3.weight")):
            v = 0.5 + torch.rand(v.shape, generator=gen)
        tv[k.removeprefix("head.extractor.")] = v
    for k in list(tv):
        if k.startswith("backbone.fpn.layer_blocks.0."):
            tv[k.replace("blocks.0.", "blocks.3.")] = tv[k].clone()
    tv["rpn.head.conv.0.0.weight"] = torch.zeros(256, 256, 3, 3)
    torch.save(tv, path)
    return tv


@pytest.mark.parametrize("option", [[], ["--lidar-only"], ["--bf16"],
                                    ["--image-weights", "w.pth"]],
                         ids=["fused", "lidar-only", "bf16",
                              "image-weights"])
def test_train_cli_synthetic_eval_and_refusals(option, tmp_path,
                                               monkeypatch, capsys):
    """``--synthetic`` with the val AP, fused, LiDAR-only, in bfloat16, or
    with ``--image-weights`` (a torchvision file): after the epoch the
    frozen extractor holds the imported weights."""
    monkeypatch.chdir(tmp_path)
    cfg_path = _yaml(tmp_path / "tiny.yaml")
    args = ["--synthetic", "2", "-n", "1", "--eval-every", "1", "--config",
            cfg_path, "--device", "cpu", *option]
    if "--image-weights" in option:
        tv = _torchvision_file(tmp_path / "w.pth", seed=3)
    assert train_cli.main(args) == 0
    assert "epoch 1 val Car: AP=" in capsys.readouterr().out
    saved = torch.load("checkpoints/epoch1", weights_only=True)["model"]
    assert any(k.startswith("head.") for k in saved) == (
        "--lidar-only" not in option)
    assert all(v.dtype == torch.float32 for v in saved.values())
    if "--image-weights" in option:
        imported = load_torchvision_fpn_weights(tv)
        assert len(imported) == sum(k.startswith("head.extractor.")
                                    for k in saved)
        for k, v in imported.items():
            assert torch.equal(saved["head.extractor.backbone." + k], v), k


def test_detector_create_restores_checkpoints(tmp_path):
    """The latest epoch by default, a named one, or (epoch 0) random
    weights from the seed."""
    cfg = load_config(None, checkpoint_dir=str(tmp_path), **KW)
    model = build_model(cfg, seed=5, device="cpu")
    state = TrainState.create(cfg, model)
    ckpt.save_checkpoint(str(tmp_path), 2, state)
    seed5 = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    ckpt.save_checkpoint(str(tmp_path), 3, state)
    epoch3 = model.state_dict()
    latest = Detector.create(cfg, device="cpu").model.state_dict()
    older = Detector.create(cfg, checkpoint_epoch=2,
                            device="cpu").model.state_dict()
    fresh = Detector.create(cfg, checkpoint_epoch=0, seed=5,
                            device="cpu").model.state_dict()
    for k, v in epoch3.items():
        assert torch.equal(latest[k], v), k
        assert torch.equal(older[k], seed5[k]), k
        assert torch.equal(fresh[k], seed5[k]), k
    assert not torch.equal(latest["head.fusion.fcn1.fc.weight"],
                           seed5["head.fusion.fcn1.fc.weight"])


def test_kitti_result_line_matches_jax_formatting(rng):
    """The JAX CLI's formatting (``mvxnet_makise_tpu/tools/detect.py``)
    of the same boxes and calib."""
    calib = toy_calib()
    jcal = JaxCalib(*calib)
    boxes = np.zeros((20, 7), np.float32)
    boxes[:, 0] = rng.uniform(5, 60, 20)
    boxes[:, 1] = rng.uniform(-20, 20, 20)
    boxes[:, 2] = rng.uniform(-2, -1, 20)
    boxes[:, 3:6] = rng.uniform(0.5, 4.5, (20, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, 20)
    scores = rng.uniform(0, 1, 20).astype(np.float32)
    for box, score in zip(boxes, scores):
        cam = np.asarray(jax_lidar_to_cam(
            np.asarray(box)[None], np.asarray(jcal.velo_to_cam)))[0]
        h, w, l, cx, cy, cz, ry = cam
        corners = np.asarray(jax_corners3d(jnp.asarray(box)))
        uv = np.asarray(jax_to_image(corners, jcal.to_numpy()))
        bbox = (uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(),
                uv[:, 1].max())
        want = (f"Car 0.0 0 0.0 "
                f"{bbox[0]:.2f} {bbox[1]:.2f} {bbox[2]:.2f} "
                f"{bbox[3]:.2f} "
                f"{h:.2f} {w:.2f} {l:.2f} "
                f"{cx:.2f} {cy:.2f} {cz:.2f} {ry:.2f} "
                f"{float(score):.4f}")
        assert detect.kitti_result_line("Car", box, score, calib) == want


def test_tools_default_to_cuda_and_raise_without_it(tree, tmp_path,
                                                    monkeypatch):
    root, cfg_path = tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [(cropdata.main, [root, "numpy"]),
             (create_gtdatabase.main, [str(tmp_path / "none")]),
             (train_cli.main, ["--synthetic", "2"]),
             (evaluate.main, [root, "--config", cfg_path]),
             (detect.main, [root, "-o", str(tmp_path / "o"), "--config",
                            cfg_path])]
    for main, args in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(args)
