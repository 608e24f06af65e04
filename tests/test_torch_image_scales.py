"""PyTorch port: ``PointImageHead`` against the JAX package at the image
scales the configurations use.

Every shipped configuration resizes its images (``image_min_side`` 800 by
default, 400 in ``serving_economy.yaml``), while the other head tests run
at native scale.  Here the head runs at 64x96 in float64 at min side 40
(shrinks), 128 (grows) and 800 (the default: 800x1200), with the
transform's output shared between the packages: both heads get the same
resized, padded image (their transforms patched to the identity), so what
is compared is the pyramid on it, the pixel-to-cell mapping of
``gather_image_size`` at that scale, the gather and the fusion MLP.
Features and the empty-slot row must sit within 1e-10 of JAX (relative to
the largest magnitude).

XLA's CPU backend has no library convolution for float64, and its own
loop takes about 50 s for JAX's ResNet-50 at 800x1216.  At min side 800
JAX's model therefore runs with ``lax.conv_general_dilated`` replaced by
``_tap_conv``: the same convolution as a sum of one float64 matmul per
kernel tap (about 8 s).  ``test_tap_conv_matches_lax`` holds it against
``lax.conv_general_dilated`` on every kind of convolution the trunk has.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from mvxnet_makise_tpu.models import image_head as jax_head
from mvxnet_makise_tpu_torch.models import image_head
from mvxnet_makise_tpu_torch.models.weights import load_jax_params

IMG = (64, 96)
P = 200
NHWC = ("NHWC", "HWIO", "NHWC")
_lax_conv = lax.conv_general_dilated


def _tap_conv(lhs, rhs, window_strides, padding, lhs_dilation=None,
              rhs_dilation=None, dimension_numbers=None,
              feature_group_count=1, batch_group_count=1, precision=None,
              preferred_element_type=None):
    """``lax.conv_general_dilated`` for float64 NHWC/HWIO as a sum over
    kernel taps of strided slices times the tap's (C, O) matrix; anything
    else goes to ``lax``."""
    dn = lax.conv_dimension_numbers(lhs.shape, rhs.shape, dimension_numbers)
    if (lhs.dtype != jnp.float64 or feature_group_count != 1
            or batch_group_count != 1
            or any(d != 1 for d in lhs_dilation or ())
            or dn != lax.conv_dimension_numbers(lhs.shape, rhs.shape, NHWC)):
        return _lax_conv(lhs, rhs, window_strides, padding, lhs_dilation,
                         rhs_dilation, dimension_numbers, feature_group_count,
                         batch_group_count, precision, preferred_element_type)
    kh, kw = rhs.shape[:2]
    dh, dw = rhs_dilation or (1, 1)
    sh, sw = window_strides
    if isinstance(padding, str):
        padding = lax.padtype_to_pads(
            lhs.shape[1:3], ((kh - 1) * dh + 1, (kw - 1) * dw + 1),
            window_strides, padding)
    x = jnp.pad(lhs, ((0, 0), tuple(padding[0]), tuple(padding[1]), (0, 0)))
    ho = (x.shape[1] - (kh - 1) * dh - 1) // sh + 1
    wo = (x.shape[2] - (kw - 1) * dw - 1) // sw + 1
    y = 0
    for i in range(kh):
        for j in range(kw):
            tap = x[:, i * dh:i * dh + (ho - 1) * sh + 1:sh,
                    j * dw:j * dw + (wo - 1) * sw + 1:sw]
            y = y + jnp.einsum("bhwc,co->bhwo", tap, rhs[i, j])
    return y


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def params():
    """The head's JAX parameters drawn with numpy: kernels with variance
    1/fan-in, folded norms around 1 and 0, other biases small."""
    rng = np.random.default_rng(7)
    jm = jax_head.PointImageHead(IMG)
    p = jax.eval_shape(
        jm.init, jax.random.key(2), jnp.zeros((1, *IMG, 3), jnp.float32),
        jnp.zeros((1, P, 2), jnp.float32), jnp.zeros((1, P), bool),
        jnp.float32(0))

    def walk(t, in_norm=False):
        out = {}
        for k, v in t.items():
            norm = in_norm or "bn" in k
            if isinstance(v, dict):
                out[k] = walk(v, norm)
            elif norm and k == "scale":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
            elif norm and k == "bias":
                out[k] = rng.normal(0, 0.1, v.shape).astype(v.dtype)
            elif k == "kernel":
                out[k] = rng.normal(0, np.prod(v.shape[:-1]) ** -0.5,
                                    v.shape).astype(v.dtype)
            else:
                out[k] = rng.normal(0, 0.1, v.shape).astype(v.dtype)
        return out
    return {"params": walk(p["params"])}


@pytest.mark.parametrize("min_side", [40.0, 128.0, 800.0])
@torch.no_grad()
def test_point_image_head_matches_jax_at_resized_scales(params, min_side,
                                                        monkeypatch):
    rng = np.random.default_rng(4)
    images = rng.uniform(0, 1, (1, *IMG, 3))
    shared = image_head.detection_transform(torch.from_numpy(images),
                                            min_side).numpy()
    assert shared.shape[1:3] == image_head.transform_output_shape(
        IMG, min_side)[1]
    rc = np.stack([rng.uniform(0, IMG[0], (1, P)),
                   rng.uniform(0, IMG[1], (1, P))], -1)
    mask = rng.random((1, P)) < 0.8
    monkeypatch.setattr(jax_head, "detection_transform", lambda im, ms: im)
    monkeypatch.setattr(image_head, "detection_transform",
                        lambda im, ms: im)

    if min_side == 800.0:
        monkeypatch.setattr(lax, "conv_general_dilated", _tap_conv)
    jm = jax_head.PointImageHead(IMG, image_min_side=min_side)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        want_x, want_z = jax.jit(jm.apply)(
            p64, jnp.asarray(shared), jnp.asarray(rc), jnp.asarray(mask),
            jnp.asarray(23.0))

    port = image_head.PointImageHead(IMG, image_min_side=min_side)
    load_jax_params(port, params)
    got_x, got_z = port.double()(
        torch.from_numpy(shared), torch.from_numpy(rc),
        torch.from_numpy(mask), torch.tensor([23.0], dtype=torch.float64))
    assert got_x.shape == (1, P, 16)
    _close(got_x.numpy(), np.asarray(want_x), 1e-10)
    _close(got_z.numpy(), np.asarray(want_z)[None], 1e-10)


@pytest.mark.parametrize("kernel,stride,padding", [
    (7, 2, ((3, 3), (3, 3))),   # the stem
    (4, 1, "VALID"),            # the space-to-depth stem
    (3, 1, "SAME"), (3, 2, "SAME"), (3, 2, ((1, 1), (1, 1))),
    (1, 1, "SAME"), (1, 2, "SAME"),
])
def test_tap_conv_matches_lax(kernel, stride, padding):
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.normal(size=(2, 13, 18, 5))
    w = rng.normal(size=(kernel, kernel, 5, 7))
    with jax.enable_x64(True):
        want = _lax_conv(jnp.asarray(x), jnp.asarray(w), (stride, stride),
                         padding, dimension_numbers=NHWC)
        got = _tap_conv(jnp.asarray(x), jnp.asarray(w), (stride, stride),
                        padding, dimension_numbers=NHWC)
    assert got.dtype == jnp.float64 and got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-12)
