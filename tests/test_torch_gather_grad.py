"""PyTorch port: K2's backward against JAX's custom VJP.

``fpn_gather`` differentiates its levels through
``ops/gather.fpn_gather_backward`` (JAX's transpose, ``_bwd`` in
``mvxnet_makise_tpu/ops/pallas_gather.py``) on both devices, and
``points_rc`` not at all, as JAX returns None for it.  Here on the CPU its
level gradients are held against ``jax.grad`` through
``fpn_gather_banded_diff(..., interpret=True)`` on the inputs of
``tests/test_pallas_gather.py`` (three levels that halve, 80 % of the
points valid), plain and swapped bilinear weights:

* float32, under ``tests/test_pallas_gather.py``'s loss (the squared
  distance to a target), to its tolerance, atol 1e-5;
* bfloat16 levels under a linear loss (its cotangent, the target rounded
  to bfloat16, does not depend on the forward, which rounds otherwise in
  the two packages): within one bfloat16 step of each value.  Both sum
  in float32 and round once; the float32 sums add in another order.

``fpn_gather_plain`` keeps autograd, which also reaches ``points_rc``:
the float32 gradients also equal its levels' gradients (1e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvxnet_makise_tpu.ops.pallas_gather import fpn_gather_banded_diff
from mvxnet_makise_tpu_torch.ops import gather

IMG = (37, 122)
SHAPES = [(16, 24, 8), (8, 12, 8), (4, 6, 8)]
B, P = 2, 48


def _data(seed):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(B, *s)).astype(np.float32) for s in SHAPES]
    rc = np.stack([rng.uniform(0, IMG[0], (B, P)),
                   rng.uniform(0, IMG[1], (B, P))], -1).astype(np.float32)
    ok = rng.random((B, P)) < 0.8
    tgt = rng.normal(size=(B, P, 24)).astype(np.float32)
    return feats, rc, ok, tgt


def _jax_grads(feats, rc, ok, tgt, swapped, dtype, squared):
    def loss(fs):
        got, pos, _ = fpn_gather_banded_diff(
            fs, jnp.asarray(rc), jnp.asarray(ok), IMG, 1e-6, swapped, 8,
            True)
        out = jnp.take_along_axis(got, pos[..., None], axis=1)
        out = out.astype(jnp.float32)
        if squared:
            return jnp.sum((out - jnp.asarray(tgt)) ** 2)
        return jnp.sum(out * jnp.asarray(tgt).astype(dtype)
                       .astype(jnp.float32))
    fs = tuple(jnp.asarray(f, dtype) for f in feats)
    return [np.asarray(g.astype(jnp.float32)) for g in jax.grad(loss)(fs)]


def _port_grads(feats, rc, ok, tgt, swapped, dtype, squared, fn):
    levels = [torch.from_numpy(f).to(dtype).requires_grad_(True)
              for f in feats]
    rc_t = torch.from_numpy(rc).requires_grad_(True)
    out = fn(levels, rc_t, torch.from_numpy(ok), IMG,
             swapped_weights=swapped).float()
    t = torch.from_numpy(tgt)
    loss = (((out - t) ** 2).sum() if squared
            else (out * t.to(dtype).float()).sum())
    loss.backward()
    return [f.grad for f in levels], rc_t.grad


def _bf16_steps(got, want):
    g, w = got.float(), torch.from_numpy(np.array(want))
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    step = torch.ldexp(torch.ones_like(g), e - 8)
    return float(((g - w).abs() / step).max())


@pytest.mark.parametrize("swapped", [False, True])
def test_float32_level_gradients_match_jax_vjp(swapped):
    feats, rc, ok, tgt = _data(2)
    want = _jax_grads(feats, rc, ok, tgt, swapped, jnp.float32, True)
    before = gather.BACKWARD.launches
    got, rc_grad = _port_grads(feats, rc, ok, tgt, swapped, torch.float32,
                               True, gather.fpn_gather)
    assert gather.BACKWARD.launches == before + 1
    assert rc_grad is None
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)
    plain, plain_rc = _port_grads(feats, rc, ok, tgt, swapped,
                                  torch.float32, True,
                                  gather.fpn_gather_plain)
    assert plain_rc is not None
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=1e-5)


@pytest.mark.parametrize("swapped", [False, True])
def test_bfloat16_level_gradients_match_jax_vjp(swapped):
    feats, rc, ok, tgt = _data(3)
    want = _jax_grads(feats, rc, ok, tgt, swapped, jnp.bfloat16, False)
    got, rc_grad = _port_grads(feats, rc, ok, tgt, swapped, torch.bfloat16,
                               False, gather.fpn_gather)
    assert rc_grad is None
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert np.abs(w).max() > 0
        assert _bf16_steps(g, w) <= 1


def test_no_gradient_without_levels_that_require_it():
    """Levels that need no gradient: no autograd node, even where
    ``points_rc`` requires one (JAX's VJP gives it none)."""
    feats, rc, ok, _ = _data(4)
    out = gather.fpn_gather([torch.from_numpy(f) for f in feats],
                            torch.from_numpy(rc).requires_grad_(True),
                            torch.from_numpy(ok), IMG)
    assert out.grad_fn is None
