"""Plain reference of one training step of the published recipe, in
float32: the colour augmentation, the code labels, the losses, the
backward and Adam. Imports nothing but torch and the reference model.

The augmentation's parameters are drawn from a `torch.Generator` in the
published chain's order (salt and pepper, motion blur, coarse dropout,
gaussian blur, add, invert, per-channel multiply, multiply, contrast; each
behind its own gate, the whole behind an outer gate of 0.8), so that a
generator seeded as the program's draws what the program drew.

The loss: BCE of the RoI bit over every keypoint, BCE of the 3 + stage x
and y code bits masked by the ground-truth RoI bit, and the L1 between the
two seg channels' probabilities and the nearest-resized visible and full
masks.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from posebench.reference import model as ref

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _rand(gen, *shape, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=gen.device)


def _channel_values(gen, B, lo, hi, per_channel_p):
    per_ch = _rand(gen, B) < per_channel_p
    v_ch = _rand(gen, B, 3, lo=lo, hi=hi)
    v_one = _rand(gen, B, 1, lo=lo, hi=hi).expand(B, 3)
    return torch.where(per_ch[:, None], v_ch, v_one)


def draw_augment(gen, B, H, W, pepper_salt=True, motion_blur=True, prob=0.8):
    """The chain's parameters for a batch: {"apply": (B,) bool, op: (gate, *params) or None}."""
    p = {"apply": _rand(gen, B) < prob}
    cells = (max(int(H * 0.05), 1), max(int(W * 0.05), 1))
    draws = (
        ("salt_and_pepper", 0.3, lambda: (_rand(gen, B, H, W) < 0.05, _rand(gen, B, H, W) < 0.5),
         not pepper_salt),
        ("motion_blur", 0.2, lambda: (torch.randint(0, 4, (B,), generator=gen,
                                                    device=gen.device),), not motion_blur),
        ("coarse_dropout", 0.4, lambda: (_rand(gen, B, *cells) >= 0.1,), False),
        ("gaussian_blur", 0.5, lambda: (_rand(gen, B, hi=1.0),), False),
        ("add_value", 0.5, lambda: (_channel_values(gen, B, -20.0, 20.0, 0.3),), False),
        ("invert", 0.4, lambda: (_rand(gen, B, 3) < 0.2,), False),
        ("multiply_ch", 0.5, lambda: (_channel_values(gen, B, 0.7, 1.4, 0.8),), False),
        ("multiply", 0.5, lambda: (_channel_values(gen, B, 0.7, 1.4, 0.0),), False),
        ("contrast", 0.5, lambda: (_channel_values(gen, B, 0.5, 2.0, 0.3),), False),
    )
    for name, prob_op, draw, off in draws:
        p[name] = None if off else (_rand(gen, B) < prob_op, *draw())
    return p


def _depthwise(img, kern):
    B, H, W, C = img.shape
    k = kern.shape[-1]
    x = img.permute(0, 3, 1, 2).reshape(1, B * C, H, W)
    w = kern[:, None].expand(B, C, k, k).reshape(B * C, 1, k, k)
    return F.conv2d(x, w, padding=k // 2, groups=B * C).view(B, C, H, W).permute(0, 2, 3, 1)


def _motion(img, idx, k=5):
    h = torch.zeros(k, k, device=img.device)
    h[k // 2, :] = 1.0 / k
    d = torch.eye(k, device=img.device) / k
    return _depthwise(img, torch.stack([h, h.t(), d, d.flip(1)])[idx])


def _gauss(img, sigma, k=5):
    sigma = sigma.clamp_min(1e-3)[:, None]
    r = torch.arange(k, dtype=torch.float32, device=img.device) - (k - 1) / 2
    g = torch.exp(-0.5 * (r / sigma) ** 2)
    g = g / g.sum(-1, keepdim=True)
    return _depthwise(img, g[:, :, None] * g[:, None, :])


def _dropout(img, keep):
    full = F.interpolate(keep[:, None].float(), size=img.shape[1:3], mode="nearest-exact")
    return img * full[:, 0, :, :, None]


OPS = {
    "salt_and_pepper": lambda x, hit, salt: torch.where(
        hit[..., None], torch.where(salt, 255.0, 0.0)[..., None], x),
    "motion_blur": _motion,
    "coarse_dropout": _dropout,
    "gaussian_blur": _gauss,
    "add_value": lambda x, v: x + v[:, None, None, :],
    "invert": lambda x, hit: torch.where(hit[:, None, None, :], 255.0 - x, x),
    "multiply_ch": lambda x, m: x * m[:, None, None, :],
    "multiply": lambda x, m: x * m[:, None, None, :],
    "contrast": lambda x, a: (x - 127.5) * a[:, None, None, :] + 127.5,
}


def _sel(hit, a, b):
    return torch.where(hit.view(-1, *([1] * (a.dim() - 1))), a, b)


def augment_normalize(images_u8, params):
    """uint8 (B, H, W, 3) -> the augmented, ImageNet-normalised float32 batch."""
    img = images_u8.float()
    x = img
    for name, fn in OPS.items():
        if params[name] is not None:
            gate, *args = params[name]
            x = _sel(gate, fn(x, *args), x)
    x = _sel(params["apply"], x.clamp(0.0, 255.0), img)
    mean = torch.tensor(MEAN, device=x.device)
    std = torch.tensor(STD, device=x.device)
    return (x / 255.0 - mean) / std


def code_labels(proj_xy, bbox, S: int):
    """(roi (B, N) f32, x_id, y_id (B, N) int64 in [0, S)): a keypoint is in
    the RoI when its projection lies past the box's corner and its
    truncated cell id is below S."""
    w, h = bbox[:, 2:3], bbox[:, 3:4]
    bad = (w <= 0) | (h <= 0)
    px = torch.where(bad, torch.ones_like(w), w / S)
    py = torch.where(bad, torch.ones_like(h), h / S)
    x = torch.trunc((proj_xy[..., 0] - bbox[:, 0:1]) / px).long()
    y = torch.trunc((proj_xy[..., 1] - bbox[:, 1:2]) / py).long()
    out = ((proj_xy[..., 0] < bbox[:, 0:1]) | (proj_xy[..., 1] < bbox[:, 1:2])
           | (x >= S) | (y >= S) | bad)
    return (~out).float(), x.clamp(0, S - 1), y.clamp(0, S - 1)


def loss(net: ref.PoseNet, imgs, knn, batch: Dict[str, torch.Tensor], stage: int,
         forced=None):
    """(the training loss of the batch (see the module's docstring), the
    network's outputs); `forced` as `PoseNet.forward` takes it."""
    out = net(imgs, knn, stage=stage, forced=forced)
    L = 3 + stage
    roi, x_id, y_id = code_labels(batch["proj_xy"], batch["bbox"], 2 ** net.res_log2)
    sh = torch.arange(net.res_log2 - 1, -1, -1, device=x_id.device)[:L]
    gx, gy = ((x_id[..., None] >> sh) & 1).float(), ((y_id[..., None] >> sh) & 1).float()
    bce = F.binary_cross_entropy_with_logits
    l_roi = bce(out["roi_logit"], roi)
    m = roi[..., None]
    den = m.sum().clamp_min(1.0) * L
    l_x = (bce(out["x_logits"], gx, reduction="none") * m).sum() / den
    l_y = (bce(out["y_logits"], gy, reduction="none") * m).sum() / den

    def seg(c, mask):
        s = out["seg_logits"][..., c]
        h, w = s.shape[1:]
        H, W = mask.shape[1:]
        yi = (torch.arange(h, dtype=torch.float32, device=s.device) * (H / h)).long()
        xi = (torch.arange(w, dtype=torch.float32, device=s.device) * (W / w)).long()
        return (torch.sigmoid(s) - mask[:, yi][:, :, xi]).abs().mean()
    return l_roi + l_x + l_y + seg(0, batch["mask_visib"]) + seg(1, batch["mask_full"]), out


class Trainer:
    """The reference's training: `net` in train mode, Adam (0.9, 0.999,
    1e-8) at `lr`, the augmentation drawn from `gen`. Activations are
    recomputed in the backward pass, block by block, so that a batch of the
    timed size fits beside nothing else."""

    def __init__(self, net: ref.PoseNet, lr: float, gen: torch.Generator, stage: int,
                 pepper_salt=True, motion_blur=True):
        self.net, self.gen, self.stage = net.train(), gen, stage
        self.flags = (pepper_salt, motion_blur)
        ref.set_checkpointing(net, True)
        self.opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                    foreach=False)

    def _inputs(self, batch):
        B, H, W, _ = batch["image"].shape
        return augment_normalize(batch["image"], draw_augment(self.gen, B, H, W, *self.flags))

    def step(self, batch: Dict[str, torch.Tensor], knn, forced=None) -> float:
        """One step; the loss. The network's outputs stay in `self.out`."""
        imgs = self._inputs(batch)
        self.opt.zero_grad(set_to_none=False)
        total, out = loss(self.net, imgs, knn, batch, self.stage, forced)
        self.out = {k: v.detach() for k, v in out.items()}
        total.backward()
        for p in self.net.parameters():        # a branch the stage leaves out
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.opt.step()
        return float(total.detach())

    def forward(self, batch: Dict[str, torch.Tensor], knn, forced=None):
        """The outputs of a step's forward, without its backward or update
        (the augmentation is drawn as a step draws it)."""
        with torch.no_grad():
            return self.net(self._inputs(batch), knn, stage=self.stage, forced=forced)

    def grads(self) -> Dict[str, torch.Tensor]:
        return {n: p.grad for n, p in self.net.named_parameters()}

