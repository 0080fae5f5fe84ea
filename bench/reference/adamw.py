"""AdamW as the training cells configure it, in plain PyTorch: the
gradients clipped by their global norm, bias correction by step + 1,
decoupled weight decay on leaves of two or more dimensions, a linear
warm-up from 0 then a cosine decay to ``min_lr_ratio`` of the peak."""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def learning_rate(opt: Dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"]) /
                max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    floor = opt["min_lr_ratio"]
    return opt["lr"] * warm * (floor + (1 - floor) * 0.5 *
                               (1 + math.cos(math.pi * t)))


class AdamW:
    def __init__(self, opt: Dict, params: List[torch.Tensor]):
        self.opt = opt
        self.params = params
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.step_count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[float]:
        """Apply one step; returns the norm of each clipped gradient, as
        the moments take it."""
        o, t = self.opt, self.step_count
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
        clip = min(o["grad_clip"] / max(float(norm), 1e-12), 1.0)
        lr = learning_rate(o, t)
        b1c, b2c = 1 - o["b1"] ** (t + 1), 1 - o["b2"] ** (t + 1)
        used = []
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g * clip
            used.append(float(torch.linalg.vector_norm(g)))
            m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            v.mul_(o["b2"]).add_(g * g, alpha=1 - o["b2"])
            upd = (m / b1c) / (torch.sqrt(v / b2c) + o["eps"])
            if p.dim() >= 2:
                upd = upd + o["weight_decay"] * p
            p.sub_(lr * upd)
        self.step_count += 1
        return used
