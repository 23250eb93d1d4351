"""Finite-difference gradient validation (counterpart of the JAX package's
diff/gradcheck.py).

The renderer is a Monte Carlo estimator, so both sides are evaluated with
common random numbers (the same seed): the comparison is then exact along
smooth paths, and what remains comes from discrete-event boundaries (which
sphere wins, lottery flips) and scales with eps.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def finite_difference_grad(
    loss_fn: Callable[[torch.Tensor], torch.Tensor],
    x,
    eps: float = 1e-3,
) -> np.ndarray:
    """Central finite differences of a scalar loss with respect to every
    element of x (evaluated at float32 points)."""
    x = np.array(x, np.float64)
    grad = np.zeros_like(x)
    flat = x.reshape(-1)
    gflat = grad.reshape(-1)
    with torch.no_grad():
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + eps
            up = float(loss_fn(torch.tensor(x, dtype=torch.float32)))
            flat[i] = orig - eps
            down = float(loss_fn(torch.tensor(x, dtype=torch.float32)))
            flat[i] = orig
            gflat[i] = (up - down) / (2.0 * eps)
    return grad


def check_grads(
    loss_fn: Callable[[torch.Tensor], torch.Tensor],
    x,
    eps: float = 1e-3,
    rtol: float = 0.1,
    atol: float = 1e-3,
) -> dict:
    """Compare the autograd gradient with central differences; returns a
    report with both gradients and the verdicts (cosine similarity and
    elementwise tolerance)."""
    xt = torch.tensor(np.asarray(x), dtype=torch.float32, requires_grad=True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(loss_fn(xt), xt)
    ad = g.detach().numpy().astype(np.float64)
    fd = finite_difference_grad(loss_fn, np.asarray(x), eps)
    denom = np.linalg.norm(ad) * np.linalg.norm(fd)
    cosine = float(np.sum(ad * fd) / denom) if denom > 0 else 1.0
    return {
        "autodiff": ad,
        "finite_difference": fd,
        "cosine": cosine,
        "allclose": bool(np.allclose(ad, fd, rtol=rtol, atol=atol)),
        "max_abs_err": float(np.max(np.abs(ad - fd))) if ad.size else 0.0,
        "rel_err": float(
            np.linalg.norm(ad - fd) / max(np.linalg.norm(fd), 1e-12)
        ),
    }
