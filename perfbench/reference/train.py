"""The plain reference of a training step: target assignment by rotated
bird's-eye-view IoU against every anchor, VoxelNet's detection loss, the
gradient by autograd through :mod:`perfbench.reference.model`, one frame at
a time, and AdamW.

- Assignment: an anchor is positive where its IoU with some real ground
  truth box is at least ``pos_iou`` (the highest-numbered such box is its
  match), and it leaves the negatives where its IoU with some box is at
  least ``neg_iou``.  The IoU is the area of the two boxes' footprints'
  intersection (the convex polygon clipped by the other's four edges)
  over their union, in float64.
- Loss of a frame: ``pos_weight`` times the mean of ``-log(score + eps)``
  over the positives, plus ``neg_weight`` times the mean of
  ``-log(1 - score + eps)`` over the negatives, plus smooth-L1 of the
  regression against the encoded matches over the positives' 7 values.
  The batch's loss is the mean of its frames'.
- AdamW with decoupled weight decay, bias-corrected moments, over every
  parameter but the frozen image trunk's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from perfbench.reference import model as R


def footprints(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) x y z l w h r -> (..., 4, 2) corners, counter-clockwise."""
    c, s = torch.cos(boxes[..., 6]), torch.sin(boxes[..., 6])
    base = torch.tensor([[0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5], [0.5, -0.5]],
                        dtype=boxes.dtype, device=boxes.device)
    px = base[:, 0] * boxes[..., 3:4]
    py = base[:, 1] * boxes[..., 4:5]
    return torch.stack([px * c[..., None] + py * s[..., None] + boxes[..., 0:1],
                        -px * s[..., None] + py * c[..., None]
                        + boxes[..., 1:2]], dim=-1)


def _clip(poly: torch.Tensor, count: torch.Tensor, a: torch.Tensor,
          b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sutherland-Hodgman: keep the part of each polygon (..., 8, 2) with
    ``count`` vertices to the left of the directed edge a -> b."""
    n = poly.shape[-2]
    e = b - a
    side = (e[..., None, 0] * (poly[..., 1] - a[..., None, 1])
            - e[..., None, 1] * (poly[..., 0] - a[..., None, 0]))
    idx = torch.arange(n, device=poly.device)
    live = idx < count[..., None]
    nxt = torch.where(idx + 1 < count[..., None], idx + 1, 0)
    q = torch.gather(poly, -2, nxt[..., None].expand_as(poly))
    sq = torch.gather(side, -1, nxt)
    inside, inside_q = side >= 0, sq >= 0
    t = side / torch.where((side - sq).abs() < 1e-30,
                           torch.full_like(side, 1e-30), side - sq)
    cross = poly + t[..., None] * (q - poly)
    # each edge p -> q emits p if inside, then the crossing if it crosses
    emit_p = live & inside
    emit_x = live & (inside != inside_q)
    pts = torch.stack([poly, cross], dim=-2).reshape(*poly.shape[:-2],
                                                      2 * n, 2)
    keep = torch.stack([emit_p, emit_x], dim=-1).reshape(*poly.shape[:-2],
                                                         2 * n)
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    pts = torch.gather(pts, -2, order[..., None].expand_as(pts))[..., :n, :]
    return pts, keep.sum(dim=-1).clamp(max=n)


def _area(poly: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    n = poly.shape[-2]
    idx = torch.arange(n, device=poly.device)
    live = idx < count[..., None]
    p = torch.where(live[..., None], poly, poly[..., :1, :])
    q = torch.roll(p, -1, dims=-2)
    return 0.5 * (p[..., 0] * q[..., 1] - q[..., 0] * p[..., 1]).sum(-1)


def iou_bev(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU of boxes a (N, 7) with boxes b (M, 7) -> (N, M)."""
    qa, qb = footprints(a.double()), footprints(b.double())
    N, M = len(a), len(b)
    poly = torch.zeros((N, M, 8, 2), dtype=torch.float64, device=a.device)
    poly[..., :4, :] = qa[:, None]
    count = torch.full((N, M), 4, dtype=torch.long, device=a.device)
    for k in range(4):
        poly, count = _clip(poly, count, qb[None, :, k].expand(N, M, 2),
                            qb[None, :, (k + 1) % 4].expand(N, M, 2))
    inter = torch.where(count >= 3, _area(poly, count), 0.0).clamp(min=0)
    area_a = (a[:, 3] * a[:, 4]).double()
    area_b = (b[:, 3] * b[:, 4]).double()
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(
        min=1e-12)


def assign(gt: torch.Tensor, gt_mask: torch.Tensor, anchors: torch.Tensor,
           neg_iou: float, pos_iou: float):
    """(pos, not_neg, match) over the (H, W, A) anchors of one frame."""
    H, W, A, _ = anchors.shape
    boxes = gt[gt_mask]
    flat = anchors.reshape(-1, 7)
    if len(boxes) == 0:
        z = torch.zeros(H * W * A, dtype=torch.bool, device=gt.device)
        return (z.reshape(H, W, A), z.reshape(H, W, A),
                torch.zeros((H, W, A), dtype=torch.long, device=gt.device))
    iou = torch.cat([iou_bev(flat[i:i + 16384], boxes)
                     for i in range(0, len(flat), 16384)])
    pos_any = iou >= pos_iou
    pos = pos_any.any(dim=1)
    not_neg = (iou >= neg_iou).any(dim=1)
    real = torch.nonzero(gt_mask).reshape(-1)
    last = torch.where(pos_any, torch.arange(len(boxes), device=gt.device),
                       -1).amax(dim=1).clamp(min=0)
    return (pos.reshape(H, W, A), not_neg.reshape(H, W, A),
            real[last].reshape(H, W, A))


def frame_loss(score, reg, targets, gt, anchors, pos_weight: float,
               neg_weight: float, eps: float) -> torch.Tensor:
    pos, not_neg, match = targets
    n_pos = pos.sum().to(score.dtype)
    total = score.numel()
    pos_loss = torch.where(pos, -torch.log(score + eps), 0.0).sum() / (
        n_pos + eps)
    neg_loss = torch.where(not_neg, 0.0, -torch.log(1 - score + eps)).sum() \
        / (total - not_neg.sum().to(score.dtype) + eps)
    deltas = R.encode(gt[match], anchors)
    d = (reg.reshape(deltas.shape) - deltas).abs()
    smooth = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    reg_loss = torch.where(pos[..., None], smooth, 0.0).sum() / (
        n_pos.clamp(min=1.0) * 7)
    return (pos_weight * pos_loss + neg_weight * neg_loss
            + torch.where(n_pos > 0, reg_loss, 0.0))


def step_grads(P: R.Params, batch: Sequence[Dict], cfg: Dict,
               q: R.Quant = R.identity) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The batch's mean loss and its gradient with respect to every
    trainable parameter, one frame at a time (every norm is per frame, so
    the batch's gradient is the mean of its frames')."""
    train = {k: v for k, v in P.items() if not R.is_frozen(k)}
    grads = {k: torch.zeros_like(v) for k, v in train.items()}
    dev = next(iter(P.values())).device
    anc = R.anchors(cfg["voxel_shape"], cfg["velo_range"], cfg["car_size"],
                    dev)
    total = 0.0
    for fr in batch:
        leaves = {k: v.detach().requires_grad_(True) for k, v in train.items()}
        params = {**P, **leaves}
        pts = fr["points"][fr["perm"]]
        n_valid = int((fr["perm"] < fr["num_points"]).sum())
        # the shuffle moves the padding rows too: keep the real rows in
        # shuffled order, then the padding
        real = fr["perm"] < fr["num_points"]
        pts = torch.cat([pts[real], pts[~real]])
        score, reg = R.forward_frame(pts, n_valid, fr.get("image"), params,
                                     cfg, q)
        targets = assign(fr["gt_boxes"], fr["gt_mask"], anc,
                         cfg["neg_iou"], cfg["pos_iou"])
        loss = frame_loss(score.float(), reg.float(), targets,
                          fr["gt_boxes"], anc, cfg["pos_weight"],
                          cfg["neg_weight"], cfg["eps"]) / len(batch)
        g = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
        for k, gk in zip(leaves, g):
            if gk is not None:
                grads[k] += gk
        total += float(loss.detach())
    return total, grads


class AdamW:
    """AdamW: decoupled weight decay, then the bias-corrected step."""

    def __init__(self, params: R.Params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: R.Params, grads: R.Params) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            p = params[k]
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k] / c2).sqrt() + self.eps
            p.add_(-self.lr * (self.m[k] / c1) / denom)


def train_steps(P: R.Params, batches: Sequence[Sequence[Dict]], cfg: Dict,
                q: R.Quant = R.identity):
    """Run the batches through the reference from weights ``P``: returns
    (losses, first gradient per leaf, change per leaf after the last
    step)."""
    params = {k: v.clone() for k, v in P.items()}
    train = {k: v for k, v in params.items() if not R.is_frozen(k)}
    opt = AdamW(train, cfg["lr"], (0.9, 0.999), cfg["eps"],
                cfg["weight_decay"])
    losses: List[float] = []
    first = None
    for batch in batches:
        loss, grads = step_grads(params, batch, cfg, q)
        losses.append(loss)
        if first is None:
            first = grads
        with torch.no_grad():
            opt.step(train, grads)
    change = {k: train[k] - P[k] for k in train}
    return losses, first, change
