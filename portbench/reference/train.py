"""The reference's training steps: plain autograd and Adam as written.

Adam (beta1 0.9, beta2 0.999, eps 1e-8 outside the square root,
bias-corrected moments), the update of ``torch.optim.Adam`` and of
optax's ``adam``, written out.
"""

from __future__ import annotations

import torch

from portbench.reference import ops


def follow(loss_fn, w0: dict, batches: list, lr: float, tf32: bool = False,
           betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """Train ``w0`` one step a batch: {"losses": [float], "grad1": {leaf:
    norm of its first gradient}, "change": {leaf: norm of its change after
    the last step}}."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in w0.items()}
    m = {k: torch.zeros_like(v) for k, v in w0.items()}
    v2 = {k: torch.zeros_like(v) for k, v in w0.items()}
    b1, b2 = betas
    losses, grad1 = [], None
    with ops.matmul_precision(tf32):
        for t, batch in enumerate(batches, start=1):
            loss = loss_fn(params, batch, tf32)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = {k: float(g.norm()) for k, g in zip(params, grads)}
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = m[k] / (1 - b1 ** t)
                    vhat = v2[k] / (1 - b2 ** t)
                    p.sub_(lr * mhat / (vhat.sqrt() + eps))
    with torch.no_grad():
        change = {k: float((p - w0[k]).norm()) for k, p in params.items()}
    return {"losses": losses, "grad1": grad1, "change": change}
