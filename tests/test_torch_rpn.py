"""PyTorch port: the RPN's two plans, and the stride-1 convolutions as
im2col and a GEMM, in float64 on the CPU.

``RPN.forward`` runs the samples one at a time through ``nn.Conv2d`` when
autograd does not record the call, and the batch in one call with its
stride-1 convolutions through ``ops/conv_gemm`` when it does.  Both
compute the function of per-sample calls: the maps, and the gradients of
every parameter and of the input, agree to 1e-10 (float64, summation
order only), at a tiny trunk with every block and deconvolution, and
samples of scales far apart, so that per-sample statistics matter.
Under ``norm_scope="batch"`` both plans equal the whole batch in one
call.
"""

import pytest
import torch
import torch.nn.functional as F

from mvxnet_makise_tpu_torch.models.blocks import set_norm_scope
from mvxnet_makise_tpu_torch.models.voxelnet import RPN
from mvxnet_makise_tpu_torch.ops.conv_gemm import (
    conv2d_gemm,
    conv_transpose2d_gemm,
)

TOL = 1e-10
# every block has stride-1 convolutions after its strided one
TRUNK = ((6, 8, 10), (2, 1, 2), 6)
SCALES = (1.0, 30.0, 0.02)


def _rpn(seed=0):
    torch.manual_seed(seed)
    rpn = RPN(5, anchors_per_loc=2, trunk=TRUNK).double()
    for m in rpn.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            torch.nn.init.uniform_(m.bias, 0.5, 1.5)
    return rpn


def _input(seed=1):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(len(SCALES), 5, 16, 24, generator=g,
                    dtype=torch.float64)
    return x * torch.tensor(SCALES, dtype=torch.float64)[:, None, None,
                                                         None]


def _per_sample(rpn, x):
    """The per-sample NCHW plan, as autograd records it."""
    maps = [rpn.forward_one(x[i:i + 1]) for i in range(x.shape[0])]
    return (torch.cat([m[0] for m in maps]),
            torch.cat([m[1] for m in maps]))


def _maps_and_grads(rpn, x, fn):
    """The maps ``fn(x)`` gives, and the gradients of a fixed random
    weighting of them for every parameter and for ``x``."""
    x = x.clone().requires_grad_(True)
    rpn.zero_grad(set_to_none=True)
    score, reg = fn(x)
    g = torch.Generator().manual_seed(2)
    ws = torch.randn(score.shape, generator=g, dtype=score.dtype)
    wr = torch.randn(reg.shape, generator=g, dtype=reg.dtype)
    ((score * ws).sum() + (reg * wr).sum()).backward()
    grads = {n: p.grad.clone() for n, p in rpn.named_parameters()}
    grads["input"] = x.grad.clone()
    return score.detach(), reg.detach(), grads


def _close(got, want):
    scale = max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) <= TOL * scale


@pytest.mark.parametrize("scope", ["sample", "batch"])
def test_grad_plan_equals_reference_maps_and_gradients(scope):
    """Under autograd ``RPN.forward`` (one batched call, stride-1
    convolutions by GEMM) equals the per-sample NCHW call under sample
    norms, and the whole batch through ``nn.Conv2d`` in one call under
    batch norms, in maps and in every gradient."""
    rpn = set_norm_scope(_rpn(), scope)
    x = _input()
    want_fn = _per_sample if scope == "sample" else RPN.forward_one
    ws, wr, wg = _maps_and_grads(rpn, x, lambda t: want_fn(rpn, t))
    gs, gr, gg = _maps_and_grads(rpn, x, rpn)
    assert _close(gs, ws) and _close(gr, wr)
    assert gg.keys() == wg.keys()
    for name in wg:
        assert wg[name].abs().max() > 0 or name.endswith("bias"), name
        assert _close(gg[name], wg[name]), name


@pytest.mark.parametrize("scope", ["sample", "batch"])
def test_no_grad_plan_is_todays_code(scope):
    """Without gradients ``RPN.forward`` runs the per-sample calls
    (sample norms) or the batch in one call (batch norms) through
    ``nn.Conv2d``, bit for bit, and equals the autograd plan to 1e-10."""
    rpn = set_norm_scope(_rpn(), scope)
    x = _input()
    with torch.no_grad():
        got = rpn(x)
        want = (_per_sample(rpn, x) if scope == "sample"
                else rpn.forward_one(x))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    ts, tr, _ = _maps_and_grads(rpn, x, rpn)
    assert _close(got[0], ts) and _close(got[1], tr)


def test_per_sample_statistics_matter():
    """The scales are far enough apart that batch-wide statistics give
    other maps: the tests above would see a plan that mixed samples."""
    rpn = _rpn()
    x = _input()
    with torch.no_grad():
        per_sample = rpn(x)
        batch_wide = set_norm_scope(rpn, "batch")(x)
    assert float((per_sample[1] - batch_wide[1]).abs().max()) > 1e-3


@pytest.mark.parametrize("kernel,padding", [(3, 1), (3, 0), (1, 0),
                                            (5, 2), ((3, 5), (0, 2))])
def test_conv2d_gemm_equals_conv2d(kernel, padding):
    g = torch.Generator().manual_seed(3)
    k = (kernel, kernel) if isinstance(kernel, int) else kernel
    p = (padding, padding) if isinstance(padding, int) else padding
    x = torch.randn(2, 3, 9, 11, generator=g, dtype=torch.float64)
    w = torch.randn(4, 3, *k, generator=g, dtype=torch.float64)
    b = torch.randn(4, generator=g, dtype=torch.float64)
    y = conv2d_gemm(x, w, b, p)
    assert y.shape == F.conv2d(x, w, b, padding=p).shape
    assert _close(y, F.conv2d(x, w, b, padding=p))
    args = [t.clone().requires_grad_(True) for t in (x, w, b)]
    assert torch.autograd.gradcheck(
        lambda a, c, d: conv2d_gemm(a, c, d, p), args)


@pytest.mark.parametrize("kernel,padding", [(3, 1), (3, 0), (2, 0),
                                            (3, 2)])
def test_conv_transpose2d_gemm_equals_conv_transpose2d(kernel, padding):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, 7, 8, generator=g, dtype=torch.float64)
    w = torch.randn(3, 5, kernel, kernel, generator=g, dtype=torch.float64)
    b = torch.randn(5, generator=g, dtype=torch.float64)
    p = (padding, padding)
    want = F.conv_transpose2d(x, w, b, padding=p)
    y = conv_transpose2d_gemm(x, w, b, p)
    assert y.shape == want.shape and _close(y, want)
    args = [t.clone().requires_grad_(True) for t in (x, w, b)]
    assert torch.autograd.gradcheck(
        lambda a, c, d: conv_transpose2d_gemm(a, c, d, p), args)


def test_conv2d_gemm_gradients_only_where_asked():
    """A frozen weight or input gets no gradient and costs no product."""
    x = torch.randn(2, 3, 6, 6, dtype=torch.float64, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, dtype=torch.float64)
    conv2d_gemm(x, w, None, (1, 1)).sum().backward()
    want = torch.autograd.grad(F.conv2d(x, w, padding=1).sum(), x)[0]
    assert _close(x.grad, want)
    x2 = x.detach()
    w2 = w.clone().requires_grad_(True)
    conv2d_gemm(x2, w2, None, (1, 1)).sum().backward()
    want = torch.autograd.grad(F.conv2d(x2, w2, padding=1).sum(), w2)[0]
    assert _close(w2.grad, want)
