"""PyTorch port: the layer library against the flax blocks, in float64.

The JAX blocks run once per sample (as ``norm_scope="sample"`` runs the
model), the port's on the whole batch with per-sample statistics.  The
same weights go to both sides; tolerance 1e-9 (float64, summation order
only)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.models import blocks as jb
from mvxnet_makise_tpu_torch.models import blocks as tb

TOL = dict(rtol=1e-9, atol=1e-9)


def _per_sample(fn, *xs):
    """Run a flax apply once per sample and stack the results."""
    outs = [fn(*[x[i:i + 1] for x in xs]) for i in range(xs[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(np.concatenate([np.asarray(o[k]) for o in outs])
                     for k in range(len(outs[0])))
    return np.concatenate([np.asarray(o) for o in outs])


def _dense_to_torch(lin, p):
    lin.weight.copy_(torch.tensor(np.asarray(p["kernel"]).T))
    lin.bias.copy_(torch.tensor(np.asarray(p["bias"])))


def test_standardize_and_masked_standardize():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 7, 4))
    m = rng.random((3, 5, 7)) < 0.6
    with jax.enable_x64(True):
        want = _per_sample(lambda a: jb.standardize(jnp.asarray(a)), x)
        want_m = _per_sample(lambda a, mm: jb.masked_standardize(
            jnp.asarray(a), jnp.asarray(mm)), x, m)
    got = tb.standardize(torch.from_numpy(x), dims=(1, 2))
    got_m = tb.masked_standardize(torch.from_numpy(x), torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got_m.numpy(), want_m, **TOL)


@torch.no_grad()
def test_dense_relu_norm():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 30, 6))
    m = rng.random((2, 30)) < 0.7
    mod = jb.DenseReluNorm(5)
    with jax.enable_x64(True):
        params = mod.init(jax.random.key(0), jnp.asarray(x[:1]))
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        want = _per_sample(lambda a, mm: mod.apply(
            params, jnp.asarray(a), jnp.asarray(mm)), x, m)
    t = tb.DenseReluNorm(6, 5).double()
    _dense_to_torch(t.fc, params["params"]["fc"])
    np.testing.assert_allclose(
        t(torch.from_numpy(x), torch.from_numpy(m)).numpy(), want, **TOL)


@torch.no_grad()
def test_dense_relu_norm_virtual():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 40, 8))
    m = rng.random((2, 40)) < 0.7
    z = rng.normal(size=(2, 8))
    nv = np.array([13.0, 0.0])
    mod = jb.DenseReluNormVirtual(6)
    with jax.enable_x64(True):
        params = mod.init(jax.random.key(1), jnp.asarray(x[:1]),
                          jnp.asarray(m[:1]), jnp.asarray(z[0]),
                          jnp.asarray(nv[0]))
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        want = _per_sample(lambda a, mm, zz, n: mod.apply(
            params, jnp.asarray(a), jnp.asarray(mm), jnp.asarray(zz[0]),
            jnp.asarray(n[0])), x, m, z, nv)
    t = tb.DenseReluNormVirtual(8, 6).double()
    _dense_to_torch(t.fc, params["params"]["fc"])
    got = t(torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(z),
            torch.from_numpy(nv))
    np.testing.assert_allclose(got[0].numpy(), want[0], **TOL)
    np.testing.assert_allclose(got[1].numpy(), want[1].reshape(2, 6), **TOL)


@torch.no_grad()
def test_dense_relu_norm_virtual_weighted():
    rng = np.random.default_rng(3)
    B, P, V, C = 2, 50, 12, 7
    x = rng.normal(size=(B, P, C))
    m = rng.random((B, P)) < 0.8
    z = rng.normal(size=(B, V, C))
    w = rng.integers(0, 5, (B, V)).astype(np.float64)
    zm = rng.random((B, V)) < 0.7
    mod = jb.DenseReluNormVirtualWeighted(9)
    with jax.enable_x64(True):
        params = mod.init(jax.random.key(2), *[jnp.asarray(a[:1]) for a in
                                               (x, m, z, w, zm)])
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        want = _per_sample(lambda *a: mod.apply(
            params, *[jnp.asarray(v) for v in a]), x, m, z, w, zm)
    t = tb.DenseReluNormVirtualWeighted(C, 9).double()
    _dense_to_torch(t.fc, params["params"]["fc"])
    got = t(*[torch.from_numpy(a) for a in (x, m, z, w, zm)])
    np.testing.assert_allclose(got[0].numpy(), want[0], **TOL)
    np.testing.assert_allclose(got[1].numpy(), want[1], **TOL)


@pytest.mark.parametrize("kernel,stride,padding", [
    (3, 2, 1), (3, 1, 1)])
@torch.no_grad()
def test_conv_relu_norm(kernel, stride, padding):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 12, 10, 5))                    # NHWC
    pad = ((padding, padding), (padding, padding))
    mod = jb.ConvReluNorm(6, (kernel, kernel), (stride, stride), pad)
    with jax.enable_x64(True):
        params = mod.init(jax.random.key(3), jnp.asarray(x[:1]))
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        want = _per_sample(lambda a: mod.apply(params, jnp.asarray(a)), x)
    t = tb.ConvReluNorm(5, 6, kernel, stride, padding).double()
    k = np.asarray(params["params"]["conv"]["kernel"])
    t.conv.weight.copy_(torch.tensor(np.transpose(k, (3, 2, 0, 1))))
    t.conv.bias.copy_(torch.tensor(
        np.asarray(params["params"]["conv"]["bias"])))
    got = t(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kernel,stride,flax_pad,torch_pad", [
    (3, 1, "SAME", 1), (2, 2, "VALID", 0), (4, 4, "VALID", 0)])
@torch.no_grad()
def test_deconv_relu_norm(kernel, stride, flax_pad, torch_pad):
    """The RPN's three deconvs: flax ConvTranspose equals torch's with
    the kernel flipped in both spatial axes."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 5, 4))
    mod = jb.DeconvReluNorm(3, (kernel, kernel), (stride, stride), flax_pad)
    with jax.enable_x64(True):
        params = mod.init(jax.random.key(4), jnp.asarray(x[:1]))
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        want = _per_sample(lambda a: mod.apply(params, jnp.asarray(a)), x)
    t = tb.DeconvReluNorm(4, 3, kernel, stride, torch_pad).double()
    k = np.asarray(params["params"]["deconv"]["kernel"])[::-1, ::-1]
    t.deconv.weight.copy_(torch.tensor(np.transpose(k, (2, 3, 0, 1)).copy()))
    t.deconv.bias.copy_(torch.tensor(
        np.asarray(params["params"]["deconv"]["bias"])))
    got = t(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
