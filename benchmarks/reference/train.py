"""Plain float32 Siamese training step of StabNet (reference:
train_bundle_nobm.py:96-160, s_net_bundle_nobm.py:139-359, configs/v2_93.py),
written as functions of a dict of weights, from the published semantics.

One forward over the pair batch (x1; x2) with BatchNorm on that batch's
statistics (training mode: the biased variance, eps 1e-5), split at B; each
branch's mesh, homographies, dense maps, black mask and strict bilinear
sample of its current frame; the per-branch terms (identity, black border,
distortion, mesh consistency, feature matches, image, L2 regularization)
weighted and gated; the temporal term between branch 1's output and branch
2's output (and its validity) sampled at the batch's flow.  Gradients come
from autograd through the plain sampler (`geometry.sample`), which is the
derivative the program's K4 and K6b compute.  Adam in optax's formula.

Nothing here imports the program.  A float32 product on the card may run in
TF32 unless it is switched off: `model.plain_precision()` switches it off.

`quant`, where given, rounds what a lower precision would round: the
trunk's and the MLP's inputs, weights and activations in the forward, and
in the backward the gradient that reaches each of them (the control).
"""

from __future__ import annotations

import math
import statistics
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmarks.reference import geometry as geo
from benchmarks.reference import model as net

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def both_ways(quant: Callable[[torch.Tensor], torch.Tensor]):
    """`quant` applied to a tensor in the forward and to its gradient in the
    backward: a training step computed at that precision."""

    class Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return quant(t)

        @staticmethod
        def backward(ctx, g):
            return quant(g)

    return Round.apply


def is_param(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


def bn_train(W, name: str, x: torch.Tensor) -> torch.Tensor:
    """Training mode: the batch's per-channel mean and biased variance."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    scale = W[f"{name}.weight"][None, :, None, None] * torch.rsqrt(var + net.BN_EPS)
    return (x - mean) * scale + W[f"{name}.bias"][None, :, None, None]


def trunk(W, x: torch.Tensor, cfg: dict, quant: Quant = None) -> torch.Tensor:
    """`model.trunk` with BatchNorm in training mode."""
    r = "resnet_v2_50"

    def q(t):
        return t if quant is None else quant(t)

    def cv(name, t, stride):
        return q(net.conv(W, name, t, stride, quant))

    def norm(name, t):
        return q(bn_train(W, name, t))

    h = net.max_pool_same(cv(f"{r}.conv1.conv", x, 2))
    for name, din, d, _, stride in net.units(cfg):
        p = f"{r}.{name}"
        pre = F.relu(norm(f"{p}.preact_bn", h))
        if din == d:
            short = h if stride == 1 else h[:, :, ::stride, ::stride]
        else:
            short = cv(f"{p}.shortcut_conv", pre, stride)
        res = F.relu(norm(f"{p}.bn1", cv(f"{p}.conv1", pre, 1)))
        res = F.relu(norm(f"{p}.bn2", cv(f"{p}.conv2.conv", res, stride)))
        h = q(short + cv(f"{p}.conv3", res, 1))
    return F.relu(norm(f"{r}.postnorm", h))


def regressor(W, x: torch.Tensor, cfg: dict, quant: Quant = None) -> torch.Tensor:
    """(B, H, W, C_in) -> (B, theta_dim), BatchNorm in training mode."""
    h = trunk(W, x.permute(0, 3, 1, 2).float(), cfg, quant).mean(dim=(2, 3))
    for i in range(3):
        name = f"head.fc{i + 1}"
        w = W[f"{name}.weight"] if quant is None else quant(W[f"{name}.weight"])
        h = F.relu(F.linear(h if quant is None else quant(h), w, W[f"{name}.bias"]))
    return F.linear(h, W["head.out.weight"], W["head.out.bias"])


def masked_mse(err: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    e = err * keep
    return ((e * e).sum(dim=(1, 2, 3)) / (keep.sum(dim=(1, 2, 3)) + 1e-8)).mean()


def distortion(pts1: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Right angles of the 8 triangles of each cell (s_net_bundle_nobm.py:
    148-181): for corners p0, p1, p2 in turn, (p1 - p0) turned by a right
    angle and scaled by the cell's aspect ratio against (p2 - p1)."""
    h, w = 2.0 / cfg["grid_h"], 2.0 / cfg["grid_w"]
    pts = pts1.reshape(-1, 2, 4)
    tl, tr, bl, br = (pts[:, :, k] for k in range(4))

    def term(p0, p1, p2, clock, ratio):
        v = p1 - p0
        turned = (torch.stack([ratio * v[:, 1], -ratio * v[:, 0]], dim=1) if clock
                  else torch.stack([-ratio * v[:, 1], ratio * v[:, 0]], dim=1))
        return (turned - (p2 - p1)).square()

    hw, wh = h / w, w / h
    loss = (term(tl, tr, br, 0, hw) + term(tr, br, bl, 0, wh) + term(br, bl, tl, 0, hw)
            + term(bl, tl, tr, 0, wh) + term(tr, tl, bl, 1, hw) + term(tl, bl, br, 1, wh)
            + term(bl, br, tr, 1, hw) + term(br, tr, tl, 1, wh))
    return loss.mean() / 8.0


def consistency(mesh: torch.Tensor) -> torch.Tensor:
    """Second differences of the mesh along both axes, each counted twice
    (the reference enumerates each vertex triple forwards and backwards)."""
    dv = 2.0 * mesh[:, 1:-1] - mesh[:, 2:] - mesh[:, :-2]
    dh = 2.0 * mesh[:, :, 1:-1] - mesh[:, :, 2:] - mesh[:, :, :-2]
    flat = torch.cat([e.reshape(e.shape[0], -1) for e in (dv, dv, dh, dh)], dim=1)
    return flat.square().mean()


def feature(matches, mask, xm, ym) -> torch.Tensor:
    """The maps read at each stable point (NDC to the nearest pixel, rounded
    half to even, clipped) against its matched unstable point: L1 over x
    and y, the mask's mean per example, the batch's mean."""
    B, H, Wd = xm.shape
    px = ((matches[..., 0] + 1.0) / 2.0 * Wd).clamp(0, Wd - 1).round().long()
    py = ((matches[..., 1] + 1.0) / 2.0 * H).clamp(0, H - 1).round().long()
    idx = (px + py * Wd)
    at = torch.stack([xm.reshape(B, -1).gather(1, idx), ym.reshape(B, -1).gather(1, idx)], -1)
    per = (at - matches[..., 2:]).abs().sum(dim=2)
    m = mask.float()
    return ((per * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)).mean()


def regularization(W, cfg: dict) -> torch.Tensor:
    """0.5 x the weighted sum of squares of every conv and dense kernel;
    `head.out` at its own decay, biases and BatchNorm not at all."""
    total = 0.0
    for name, shape, _ in net.param_spec(cfg):
        if name.endswith(".weight") and len(shape) >= 2:
            decay = cfg["head_weight_decay"] if name == "head.out.weight" else cfg["weight_decay"]
            total = total + decay * W[name].square().sum()
    return 0.5 * total


def gates(cfg: dict, step: int) -> Dict[str, float]:
    """The loss gates of `step` (train_bundle_nobm.py:219-236)."""
    return {"black": float(step >= cfg["do_black_loss_iter"]),
            "temp": float(step >= cfg["do_temp_loss_iter"]),
            "theta_only": float(step <= cfg["do_theta_only_iter"])}


def branch(out: dict, y, matches, mask, regu, cfg: dict, g: Dict[str, float]) -> torch.Tensor:
    """One half's terms, weighted and gated (s_net_bundle_nobm.py:308-359)."""
    m = cfg["loss_mul"]
    theta = out["theta"].abs().mean()
    bound = 1.0 / cfg["do_crop_rate"]
    pts1 = out["pts1"]
    hinge = (pts1 - bound).clamp_min(0.0) + (-bound - pts1).clamp_min(0.0)
    gated = (masked_mse(out["output"] - y, (1.0 - out["black"])[..., None]) * m["img"]
             + regu * m["regu"]
             + hinge.square().mean() * m["black"] * g["black"]
             + distortion(pts1, cfg) * m["distortion"]
             + consistency(out["mesh"]) * m["consistency"]
             + feature(matches, mask, out["x_map"], out["y_map"]) * m["feature"])
    return (theta * m["id"] * m["theta"] + theta * m["id"] * m["grid_theta"]
            + (1.0 - g["theta_only"]) * gated)


def forward(W, x: torch.Tensor, cfg: dict, quant: Quant = None) -> dict:
    """The regressor, the mesh and the warp of the current frame (the
    stack's last channel) at the mesh's dense maps."""
    theta = regressor(W, x, cfg, quant)
    mesh = geo.theta_to_mesh(theta, cfg)
    corners = geo.cell_corners(mesh)
    xm, ym = geo.dense_maps(geo.homographies(mesh, cfg), cfg["height"], cfg["width"])
    return {"theta": theta, "mesh": mesh,
            "pts1": torch.cat([corners[..., 0], corners[..., 1]], dim=-1),
            "x_map": xm, "y_map": ym, "black": geo.black_mask(xm, ym),
            "output": geo.sample(x[..., -1:].float(), xm, ym)}


def siamese_loss(W, batch: Dict[str, torch.Tensor], cfg: dict, step: int,
                 quant: Quant = None) -> torch.Tensor:
    """The full loss of one batch at `step`."""
    B = batch["x1"].shape[0]
    out = forward(W, torch.cat([batch["x1"], batch["x2"]]), cfg, quant)
    o1 = {k: v[:B] for k, v in out.items()}
    o2 = {k: v[B:] for k, v in out.items()}
    g = gates(cfg, step)
    regu = regularization(W, cfg)
    total = (branch(o1, batch["y1"], batch["matches1"], batch["mask1"], regu, cfg, g)
             + branch(o2, batch["y2"], batch["matches2"], batch["mask2"], regu, cfg, g))
    stacked = torch.cat([o2["output"], (1.0 - o2["black"])[..., None]], dim=-1)
    warped = geo.sample(stacked, batch["flow"][..., 0], batch["flow"][..., 1])
    keep = (1.0 - o1["black"])[..., None] * warped[..., 1:2]
    temp = masked_mse(o1["output"] - warped[..., 0:1], keep) * g["temp"]
    return total + temp * cfg["loss_mul"]["temp"]


def learning_rate(cfg: dict, step: int) -> float:
    return cfg["initial_learning_rate"] * cfg["lr_decay_rate"] ** math.floor(
        step / cfg["step_size"])


def follow(W0: Dict[str, torch.Tensor], batches: List[Dict[str, torch.Tensor]], cfg: dict,
           quant: Quant = None) -> dict:
    """Train from `W0` on `batches`, one Adam step each, from the
    configuration's `start_step`.  Returns each step's loss, the first
    step's gradient norm of each parameter, and each parameter's change
    after the last step (a norm), all on the host."""
    net.plain_precision()
    a = cfg["adam"]
    step0 = cfg["start_step"]
    names = [n for n in W0 if is_param(n)]
    W = {n: t.detach().clone().float() for n, t in W0.items()}
    mu = {n: torch.zeros_like(W[n]) for n in names}
    nu = {n: torch.zeros_like(W[n]) for n in names}
    Q = None if quant is None else both_ways(quant)
    losses, first = [], None
    for k, batch in enumerate(batches):
        for n in names:
            W[n].requires_grad_(True)
        loss = siamese_loss(W, batch, cfg, step0 + k, Q)
        grads = torch.autograd.grad(loss, [W[n] for n in names])
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: float(g.norm()) for n, g in zip(names, grads)}
        lr = learning_rate(cfg, step0 + k)
        c1 = 1.0 - a["b1"] ** (k + 1)
        c2 = 1.0 - a["b2"] ** (k + 1)
        with torch.no_grad():
            for n, g in zip(names, grads):
                W[n] = W[n].detach()
                mu[n].mul_(a["b1"]).add_(g, alpha=1.0 - a["b1"])
                nu[n].mul_(a["b2"]).add_(g * g, alpha=1.0 - a["b2"])
                W[n] -= lr * (mu[n] / c1) / ((nu[n] / c2).sqrt() + a["eps"])
        del grads, loss
    change = {n: float((W[n] - W0[n].float()).norm()) for n in names}
    return {"losses": losses, "grad": first, "change": change}


def gaps(prog: dict, ref: dict, nought: float) -> Dict[str, float]:
    """The compared numbers of a run that reads `prog` (its losses, first
    gradient and change, as `follow` returns them) against the reference's
    `ref`.  A leaf's gap of norms is taken against the reference's norm of
    that leaf or of the median leaf, whichever is larger; the change leaves
    out the leaves whose reference gradient is under `nought` times the
    median leaf's (nought to rounding: a conv bias under BatchNorm)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    g = ref["grad"]
    med = statistics.median(g.values())
    grad = [abs(prog["grad"][n] - g[n]) / max(g[n], med) for n in g]
    moved = [n for n in g if g[n] >= nought * med]
    c = ref["change"]
    medc = statistics.median(c[n] for n in moved)
    change = [abs(prog["change"][n] - c[n]) / max(c[n], medc) for n in moved]
    return {"loss_gap": loss, "grad_gap": statistics.median(grad), "grad_worst": max(grad),
            "change_gap": max(change)}
