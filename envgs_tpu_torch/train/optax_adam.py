"""optax.adam written out, for the families whose parameters are a JAX
parameter tree (PointPlanes, NeRF, NeuS, ENeRF): the state is (count, mu,
nu) with the moments in the order of the flattened tree, the leaf order of
optax's ScaleByAdamState, so a `latest.npz` of either package's loop
resumes in the other (train/families.py::FamilyLoop)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32
    mu: list
    nu: list


def adam_init(params: list) -> AdamState:
    return AdamState(
        torch.zeros((), dtype=torch.int32, device=params[0].device),
        [torch.zeros_like(p) for p in params],
        [torch.zeros_like(p) for p in params])


def grads_of(loss: torch.Tensor, params: list) -> list:
    """d loss / d each of `params`, zeros for a parameter the loss does not
    reach (JAX's gradient of an unused leaf)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


@torch.no_grad()
def adam_update(params: list, grads: list, state: AdamState, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                eps_root: float = 0.0) -> AdamState:
    """One optax.adam step in place on `params`: mu and nu as moving
    averages of g and g^2, the bias corrections 1 - b^count in float32,
    the update -lr * mu_hat / (sqrt(nu_hat + eps_root) + eps)."""
    count = state.count + 1
    cf = count.to(torch.float32)
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32, device=cf.device) ** cf
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32, device=cf.device) ** cf
    mus, nus = [], []
    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        m = (1 - b1) * g + b1 * m
        v = (1 - b2) * g ** 2 + b2 * v
        u = (m / bc1) / (torch.sqrt(v / bc2 + eps_root) + eps)
        p.add_(-lr * u)
        mus.append(m)
        nus.append(v)
    return AdamState(count, mus, nus)
