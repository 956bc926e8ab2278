"""AdamW with decoupled weight decay, global-norm clipping and a linear
warmup + cosine schedule (the JAX package's ``optim/adamw.py``), on nested
dicts of tensors.

Moments are fp32.  Decay applies to tensors of two or more dimensions only;
the clip comes before ``grad_transform``.  :func:`adamw_update` updates the
parameters and both moments in place (the JAX package returns new trees),
so the card holds one copy of the training state; the step, the learning
rate and the norm stay tensors on the state's device, and an update waits
for nothing on the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (an int tensor, any shape) in fp32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = (cfg.min_lr_frac
           + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return cfg.lr * warm * cos


def adamw_init(params):
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(l.float() ** 2) for l in leaves))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state, step,
                 grad_transform=None):
    """-> (params, opt_state, metrics), the first two updated in place.

    ``step`` is the int32 step tensor of the state; ``metrics`` holds the
    pre-clip ``grad_norm`` and the ``lr`` as tensors."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    grads = tree_map(lambda g: g.float() * scale, grads)
    if grad_transform is not None:
        grads = grad_transform(grads)
    lr = schedule(cfg, step)
    t = step.float() + 1.0
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)

    def upd(p, g, m, v):
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * (g * g))
        step_ = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        if p.dim() >= 2:
            step_ = step_ + cfg.weight_decay * pf
        p.copy_(pf - lr * step_)

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
