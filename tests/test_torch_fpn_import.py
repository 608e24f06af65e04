"""PyTorch port: torchvision ResNet50-FPN weights into the frozen
extractor (``models/resnet_fpn.load_torchvision_fpn_weights``).

torchvision is not installed here, so the module tree that
``fasterrcnn_resnet50_fpn_v2`` builds for its backbone is rebuilt in this
file (``IntermediateLayerGetter(resnet50)`` as ``body``, the
``FeaturePyramidNetwork`` with v2 ``Conv2dNormActivation`` blocks as
``fpn``), with every parameter and BatchNorm statistic random.  The port's
loader must consume every key in strict mode, flag a renamed block, take
the ``backbone.`` prefix, equal bit for bit the JAX loader's result
loaded into the port's module (``models/weights.load_jax_params``), and
make the port's ``ResNet50FPN`` compute what the torch modules compute in
eval mode (float32, 1e-4 of the largest value after ~50 layers).
``tools.train.read_image_weights`` takes a saved module's state dict.
"""

import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as tF

from mvxnet_makise_tpu.models.resnet_fpn import (
    load_torchvision_fpn_weights as jax_load,
)
from mvxnet_makise_tpu_torch.models.resnet_fpn import (
    ResNet50FPN,
    load_torchvision_fpn_weights,
)
from mvxnet_makise_tpu_torch.models.weights import load_jax_params
from mvxnet_makise_tpu_torch.tools.train import read_image_weights


class _Bottleneck(tnn.Module):
    """torchvision.models.resnet.Bottleneck (its state-dict keys)."""

    def __init__(self, cin, planes, stride=1, downsample=False):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, stride=stride,
                                padding=1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.conv3 = tnn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(planes * 4)
        self.downsample = tnn.Sequential(
            tnn.Conv2d(cin, planes * 4, 1, stride=stride, bias=False),
            tnn.BatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = tF.relu(self.bn1(self.conv1(x)))
        y = tF.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return tF.relu(y + idt)


class _Body(tnn.Module):
    """IntermediateLayerGetter(resnet50): conv1, bn1, layer1..layer4."""

    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        cin, planes = 64, 64
        for li, blocks in enumerate((3, 4, 6, 3)):
            stride = 1 if li == 0 else 2
            layer = [_Bottleneck(cin if bi == 0 else planes * 4, planes,
                                 stride=stride if bi == 0 else 1,
                                 downsample=bi == 0)
                     for bi in range(blocks)]
            setattr(self, f"layer{li + 1}", tnn.Sequential(*layer))
            cin, planes = planes * 4, planes * 2

    def forward(self, x):
        x = tF.relu(self.bn1(self.conv1(x)))
        x = tF.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for li in range(4):
            x = getattr(self, f"layer{li + 1}")(x)
            feats.append(x)
        return feats


class _FPN(tnn.Module):
    """FeaturePyramidNetwork with the v2 Conv2dNormActivation blocks."""

    def __init__(self):
        super().__init__()
        self.inner_blocks = tnn.ModuleList([
            tnn.Sequential(tnn.Conv2d(c, 256, 1, bias=False),
                           tnn.BatchNorm2d(256))
            for c in (256, 512, 1024, 2048)])
        self.layer_blocks = tnn.ModuleList([
            tnn.Sequential(tnn.Conv2d(256, 256, 3, padding=1, bias=False),
                           tnn.BatchNorm2d(256))
            for _ in range(4)])

    def forward(self, feats):
        laterals = [blk(f) for blk, f in zip(self.inner_blocks, feats)]
        merged = [None] * 4
        merged[3] = laterals[3]
        for li in range(2, -1, -1):
            up = tF.interpolate(merged[li + 1],
                                size=laterals[li].shape[-2:],
                                mode="nearest")
            merged[li] = laterals[li] + up
        return [blk(m) for blk, m in zip(self.layer_blocks, merged)]


class _Backbone(tnn.Module):
    def __init__(self):
        super().__init__()
        self.body = _Body()
        self.fpn = _FPN()

    def forward(self, x):
        return self.fpn(self.body(x))


@pytest.fixture(scope="module")
def twin():
    """The torchvision tree, every parameter and BN statistic random
    (fixed seed), in eval mode."""
    gen = torch.Generator().manual_seed(0)
    m = _Backbone()
    with torch.no_grad():
        for p in m.parameters():
            if p.dim() == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.normal_(0, (2.0 / fan_in) ** 0.5 * 0.5, generator=gen)
            else:
                p.normal_(0, 0.05, generator=gen)
        for mod in m.modules():
            if isinstance(mod, tnn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.1, generator=gen)
                mod.running_var.uniform_(0.8, 1.2, generator=gen)
                mod.weight.normal_(1.0, 0.05, generator=gen)
                mod.bias.normal_(0, 0.1, generator=gen)
    return m.eval()


def test_strict_consumes_every_key_and_equals_jax(twin):
    sd = twin.state_dict()
    assert len(sd) > 300
    got = load_torchvision_fpn_weights(sd, strict=True)
    want = ResNet50FPN()
    load_jax_params(want, jax_load(sd, strict=True))
    want = want.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k


def test_strict_flags_renamed_and_missing_blocks(twin):
    sd = dict(twin.state_dict())
    sd["body.layer9.0.conv1.weight"] = torch.zeros(4, 4, 1, 1)
    with pytest.raises(ValueError, match="not consumed"):
        load_torchvision_fpn_weights(sd, strict=True)
    # not strict: a Faster R-CNN state dict carries rpn/roi_heads keys
    load_torchvision_fpn_weights(sd)
    sd2 = dict(twin.state_dict())
    del sd2["fpn.inner_blocks.2.0.weight"]
    with pytest.raises(KeyError):
        load_torchvision_fpn_weights(sd2, strict=True)


def test_backbone_prefix_and_numpy_values(twin):
    sd = twin.state_dict()
    plain = load_torchvision_fpn_weights(sd, strict=True)
    prefixed = load_torchvision_fpn_weights(
        {f"backbone.{k}": v.numpy() for k, v in sd.items()}, strict=True)
    assert all(torch.equal(plain[k], prefixed[k]) for k in plain)


@torch.no_grad()
def test_forward_matches_torch_modules(twin):
    port = ResNet50FPN().eval()
    port.load_state_dict(load_torchvision_fpn_weights(twin.state_dict(),
                                                      strict=True))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 3, 64, 96)).astype(np.float32))
    want, got = twin(x), port(x)
    assert len(got) == 3
    for g, w in zip(got, want[:3]):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()))


def test_read_image_weights_takes_a_saved_modules_state_dict(twin,
                                                             tmp_path):
    path = tmp_path / "fpn.pth"
    torch.save(torch.nn.ModuleDict({"backbone": twin}), path)
    got = read_image_weights(str(path))
    assert sorted(got) == sorted("backbone." + k for k in twin.state_dict())
    load_torchvision_fpn_weights(got, strict=True)
