"""AdamW + global-norm clipping on PyTorch tensors (the counterpart of the
reference's ``training/optimizer.py``), with the reference's arithmetic.

Optimizer state mirrors the parameter tree: fp32 moments ``mu`` and
``nu`` shaped like each leaf, and the step count.  Leaves are visited in
the order ``jax.tree`` flattens a dict (sorted keys), so the global norm
sums them in the reference's order.  The updates are plain tensor ops
under ``no_grad``, not ``torch.optim.AdamW``, whose decoupled weight
decay rounds otherwise.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def init_state(params) -> dict:
    """Zero fp32 moments like every leaf (the reference's ``zeros_like``
    of its fp32 masters), and step 0 as a 0-d int32 tensor."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac, in fp32."""
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1.0) / cfg.warmup_steps, max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig, *,
                  donate: bool = False, norm=global_norm):
    """Returns (new_params, new_state, metrics {"grad_norm", "lr"}).

    The reference's arithmetic: the lr from the step before the
    increment, the bias corrections from the step after, the raw grads
    clipped by their global norm, decay on leaves of two or more
    dimensions only.  With ``donate`` the parameters and moments are
    updated in place and returned (the counterpart of the reference's
    donated buffers under ``jit``): the same values, without a second
    copy of the state.  On a rank's slices of a sharded tree (moments
    shaped as the slices) ``norm`` is the layout's global norm over the
    whole tree (``dist.fsdp.ShardedLayout.global_norm``); a slice has its
    whole leaf's ``ndim``, so the decay rule holds as it is."""
    step = state["step"] + 1
    gnorm = norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    lr = schedule(cfg, state["step"])
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        new_mu = b1 * mu + (1 - b1) * g
        new_nu = b2 * nu + (1 - b2) * torch.square(g)
        mhat = new_mu / bc1
        vhat = new_nu / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.ndim >= 2:  # decay matrices only (norms/biases exempt)
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        if donate:
            p.copy_(new_p)
            mu.copy_(new_mu)
            nu.copy_(new_nu)
            return p, mu, nu
        return new_p, new_mu, new_nu

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    pick = lambda i: tree_map(lambda o: o[i], out)
    new_state = {"mu": pick(1), "nu": pick(2), "step": step}
    return pick(0), new_state, {"grad_norm": gnorm, "lr": lr}
