"""Plain training step: the regression losses, the global-norm clip and
AdamW, worked out again in float32 for the benchmark's reference.

The objectives are the reference's (multi-scale gradient loss plus masked
L2 for gravity, the same plus MSE and a quadratic overflow penalty on the
pre-clamp output for latitude, MSE on the camera parameters divided by their
factors); the clip is optax's ``clip_by_global_norm`` (scale by max/||g||
only where ||g|| >= max); AdamW is ``torch.optim.AdamW``'s update with
weight decay applied to every parameter. Stochastic depth draws its masks,
block by block, from a generator seeded by the step, by the same rule as the
training program, so both sides drop the same branches.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def step_generator(step: int, device) -> torch.Generator:
    """The generator of a step's stochastic-depth masks: seeded from (0,
    step) through numpy's SeedSequence, two 32-bit words."""
    state = np.random.SeedSequence([0, step]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def drop_masks(net, batch: int, step: int, device) -> list:
    """Per block (in order), the two branches' keep masks of a training
    step: None where the block's rate is 0, else U(0, 1) < 1 - rate drawn
    as a (batch, 1, 1, 1) tensor for each branch in turn."""
    gen = step_generator(step, device)
    masks = []
    for blk in net.backbone.blocks():
        if blk.rate == 0.0:
            masks.append((None, None))
            continue
        pair = tuple(torch.rand((batch, 1, 1, 1), generator=gen, device=device) < 1.0 - blk.rate
                     for _ in range(2))
        masks.append(pair)
    return masks


def _one_scale(diff, mask):
    v = mask[:, :-2] * mask[:, 2:]
    hm = mask[:, :, :-2] * mask[:, :, 2:]
    num = ((diff[:, :-2] - diff[:, 2:]).abs() * v).sum() + ((diff[:, :, :-2] - diff[:, :, 2:]).abs() * hm).sum()
    return num / (v.sum() + hm.sum() + _EPS)


def msgil(pred, gt, mask, scales=4):
    diff = pred - gt
    mask = mask.to(diff.dtype)
    return sum(_one_scale(diff[:, ::2**i, ::2**i], mask[:, ::2**i, ::2**i]) for i in range(scales))


def losses(out: dict, batch: dict, params: tuple, factors: tuple) -> dict:
    """The regression objectives of one batch (all weights 1)."""
    gt_g, gt_l = batch["gt_gravity"], batch["gt_latitude"]
    mask = torch.linalg.vector_norm(gt_g, dim=-1, keepdim=True) > 1e-5
    pg = out["pred_gravity"]
    parts = {
        "gravity-msg-normal-loss": 0.1 * msgil(pg, gt_g, mask.expand(pg.shape)),
        "gravity-l2-loss": (((pg - gt_g) ** 2).sum(-1, keepdim=True) * mask).sum() / (mask.sum() + _EPS),
    }
    pl = out["pred_latitude"]
    parts["latitude-msg-normal-loss"] = 0.1 * msgil(pl, gt_l, torch.ones_like(pl, dtype=torch.bool))
    parts["latitude-l2-loss"] = ((pl - gt_l) ** 2).mean()
    parts["latitude-sat-loss"] = ((out["latitude_raw"].abs() - 1.0).clamp_min(0.0) ** 2).mean()
    pred = torch.stack([out[f"pred_{k}"] for k in params], dim=-1)
    div = torch.tensor(factors, dtype=pred.dtype, device=pred.device)
    parts["param-loss"] = ((pred / div - batch["gt_params"]) ** 2).mean()
    return parts


class AdamW:
    """torch.optim.AdamW's update (betas, eps, decoupled weight decay, bias
    correction) on a list of float32 parameters, written out."""

    def __init__(self, params, lr, weight_decay, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.wd, self.betas, self.eps = list(params), lr, weight_decay, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1.0 - b1**self.t, 1.0 - b2**self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1.0 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.addcdiv_(m, (v / c2).sqrt_().add_(self.eps), value=-self.lr / c1)


def clip_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place; returns the global norm."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    if norm >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)
    return norm


def run_steps(net, batches, opt_cfg: dict, params: tuple, factors: tuple, rows=None) -> dict:
    """Three (or len(batches)) training steps of ``net`` from its current
    parameters on ``batches`` (dicts of device tensors). ``rows``: train on
    that slice of each batch only (a fault of the program planted in the
    reference: half of the batch left out). Returns each step's loss, the
    first step's clipped gradients' per-leaf norms and each leaf's change
    over the steps."""
    names = [n for n, _ in net.named_parameters()]
    plist = [p for _, p in net.named_parameters()]
    start = [p.detach().clone() for p in plist]
    opt = AdamW(plist, opt_cfg["learning_rate"], opt_cfg["weight_decay"])
    net.train()
    losses_out, first_grad = [], None
    for step, batch in enumerate(batches):
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
        b = batch["image"].shape[0]
        for p in plist:
            p.grad = None
        out = net(batch["image"], drop_masks(net, b, step, batch["image"].device))
        loss = sum(losses(out, batch, params, factors).values())
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in plist]
        clip_(grads, opt_cfg["grad_clip"])
        if first_grad is None:
            first_grad = [float(torch.linalg.vector_norm(g)) for g in grads]
        opt.step(grads)
        losses_out.append(float(loss.detach()))
    change = [float(torch.linalg.vector_norm(p.detach() - s)) for p, s in zip(plist, start)]
    return {"names": names, "loss": losses_out, "grad_norm": first_grad, "change_norm": change}
