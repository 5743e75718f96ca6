"""AdamW with dtype-configurable state (fp32 / bf16 m, v) and global-norm
clipping over nested dicts of tensors — twin of ``repro.optim.adamw``.
Functional, as the reference: ``update`` returns new tensors."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    state_dtype: str = "float32"   # bf16 halves optimizer memory


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor      # int32 []


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up then cosine decay to 10% of ``cfg.lr`` (fp32)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init(params, cfg: OptConfig) -> OptState:
    dt = getattr(torch, cfg.state_dtype)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(l.float().square().sum() for l in tree_leaves(tree)))


@torch.no_grad()
def update(grads, state: OptState, params, cfg: OptConfig):
    """Returns (new_params, new_state, metrics)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())
    dt = getattr(torch, cfg.state_dtype)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g.square()
        del g        # one expression below: its temporaries die early
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if p.dim() > 1:  # no decay on norms / biases / scalars
            delta = delta + cfg.weight_decay * p.float()
        return ((p.float() - lr * delta).to(p.dtype), m32.to(dt),
                v32.to(dt))

    def walk(p, g, m, v):
        if isinstance(p, dict):
            outs = {k: walk(p[k], g[k], m[k], v[k]) for k in p}
            return tuple({k: o[i] for k, o in outs.items()}
                         for i in range(3))
        return upd(p, g, m, v)

    new_params, new_m, new_v = walk(params, grads, state.m, state.v)
    return new_params, OptState(new_m, new_v, step), \
        {"grad_norm": gnorm, "lr": lr}
