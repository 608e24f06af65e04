"""PyTorch port: the image branch against the JAX package.

Detection-transform geometry and resize (one upsampling and one
downsampling size: ``jax.image.resize`` antialiases when it shrinks),
the ResNet50-FPN pyramid levels, and ``PointImageHead`` (FPN gather and
the 768 -> 16 fusion MLP with its empty-slot row ``z``), with the same
weights on both sides (``models/weights.load_jax_params``).

Tolerances: the transform computes in float32 on both sides (1e-5); the
pyramid and the head compare in float64 (1e-8 relative to the largest
magnitude: ~50 convolution layers summed in other orders).  The JAX head
runs once per sample, as ``norm_scope="sample"`` runs it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.models import image_head as jax_head
from mvxnet_makise_tpu.models.resnet_fpn import ResNet50FPN as JaxFPN
from mvxnet_makise_tpu_torch.models import image_head
from mvxnet_makise_tpu_torch.models.resnet_fpn import ResNet50FPN
from mvxnet_makise_tpu_torch.models.weights import load_jax_params

IMG = (64, 96)


def _x64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _randomize_norms(tree, rng):
    """Folded norms initialize to the identity; give them random
    scales and biases so the mapping of each one is exercised."""
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
            else:
                out[k] = np.asarray(v)
        return out
    return walk(tree)


def _close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("size,min_side", [
    ((370, 1224), 800.0), ((370, 1224), 400.0), ((370, 1224), 0.0),
    ((64, 96), 40.0), ((64, 96), 128.0)])
def test_transform_geometry_matches_jax(size, min_side):
    assert (image_head.transform_output_shape(size, min_side)
            == jax_head.transform_output_shape(size, min_side))
    assert (image_head.gather_image_size(size, min_side)
            == jax_head.gather_image_size(size, min_side))


@pytest.mark.parametrize("min_side", [128.0, 40.0])
def test_detection_transform_matches_jax(min_side):
    """128 upsamples 64x96 to 128x192; 40 shrinks it to 40x60 (padded to
    64x64), where both sides must antialias."""
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, *IMG, 3)).astype(np.float32)
    want = jax.vmap(lambda im: jax_head.detection_transform(
        im, min_side))(jnp.asarray(images))
    got = image_head.detection_transform(torch.from_numpy(images), min_side)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@torch.no_grad()
def test_resnet_fpn_levels_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, *IMG, 3))
    jm = JaxFPN()
    params = jax.jit(jm.init)(jax.random.key(0),
                              jnp.zeros((1, *IMG, 3), jnp.float32))
    params = {"params": _randomize_norms(params["params"], rng)}
    with jax.enable_x64(True):
        want = jax.jit(jm.apply)(_x64(params), jnp.asarray(x))
    port = ResNet50FPN()
    load_jax_params(port, params)
    got = port.double()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape) for g in got] == [
        (2, 256, 16, 24), (2, 256, 8, 12), (2, 256, 4, 6)]
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w, 1e-8)


@torch.no_grad()
def test_point_image_head_matches_jax():
    """Pyramid, K2's plain version (against JAX's default gather), and the
    fusion MLP: per-point (B, P, 16) features and the empty-slot row.

    At native scale: with a resize, the float32 transform rounds one ulp
    apart on the two sides (the resizes agree to 2e-16 in float64), and
    the untrained fusion MLP's norms amplify that beyond float64's
    tolerance."""
    rng = np.random.default_rng(2)
    B, P = 2, 200
    images = rng.uniform(0, 1, (B, *IMG, 3))
    rc = np.stack([rng.uniform(0, IMG[0], (B, P)),
                   rng.uniform(0, IMG[1], (B, P))], -1)
    mask = rng.random((B, P)) < 0.8
    n_virtual = np.array([37.0, 0.0])
    jm = jax_head.PointImageHead(IMG, image_min_side=0.0)
    params = jax.jit(jm.init)(
        jax.random.key(1), jnp.zeros((1, *IMG, 3), jnp.float32),
        jnp.zeros((1, P, 2), jnp.float32), jnp.zeros((1, P), bool),
        jnp.float32(0))
    params = {"params": _randomize_norms(params["params"], rng)}
    # compiled without XLA's algebraic simplifier, which turns the
    # transform's division by the ImageNet std into a multiplication one
    # float32 ulp away (eager JAX and the port both divide)
    with jax.enable_x64(True):
        args = (_x64(params), jnp.asarray(images[:1]), jnp.asarray(rc[:1]),
                jnp.asarray(mask[:1]), jnp.asarray(n_virtual[0]))
        apply = jax.jit(jm.apply).lower(*args).compile(
            compiler_options={"xla_disable_hlo_passes": "algsimp"})
        outs = [apply(args[0], jnp.asarray(images[i:i + 1]),
                      jnp.asarray(rc[i:i + 1]), jnp.asarray(mask[i:i + 1]),
                      jnp.asarray(n_virtual[i])) for i in range(B)]
    want_x = np.concatenate([np.asarray(o[0]) for o in outs])
    want_z = np.stack([np.asarray(o[1]) for o in outs])

    port = image_head.PointImageHead(IMG, image_min_side=0.0)
    load_jax_params(port, params)
    got_x, got_z = port.double()(*map(torch.from_numpy,
                                      (images, rc, mask, n_virtual)))
    assert got_x.shape == (B, P, 16) and got_z.shape == (B, 16)
    _close(got_x.numpy(), want_x, 1e-8)
    _close(got_z.numpy(), want_z, 1e-8)
