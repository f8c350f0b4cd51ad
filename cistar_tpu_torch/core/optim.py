"""Adam with optax's semantics, as a functional update over lists of tensors.

The JAX engine builds ``optax.inject_hyperparams(optax.adam)(lr, b1=0.5,
b2=0.999)`` (``engines/cyclegan.py:104``): eps 1e-8, eps_root 0, the
learning rate set for each step. Its update, in the same fp32 operations
and order:

    mu    = (1 − b1) · g + b1 · mu
    nu    = (1 − b2) · g² + b2 · nu
    count = count + 1
    p     = p + (−lr · (mu / (1 − b1^count)) / (√(nu / (1 − b2^count)) + eps)) · mask

The hyperparameters are fp32 values, as ``inject_hyperparams`` holds them:
``1 − b2`` is ``1 − fp32(0.999)``, not the fp32 of 0.001.

The UDA image critic (``engines/extended.py::R2LImageCritic``) builds
``optax.chain(optax.add_decayed_weights(wd), optax.adam(lr, b1, b2))``
instead, ``injected=False`` here. Two differences: the weight decay is
added to the gradient before Adam, ``g + wd · p`` (coupled, as
``torch.optim.Adam(weight_decay=…)``, not AdamW); and the hyperparameters
are Python floats, so ``1 − b1`` and ``1 − b2`` are rounded once to fp32
(``1 − 0.9`` is 0.1f, where the injected form computes
``1 − fp32(0.9)``).

The step is gated by a device bool ``mask``: where it is false, the params
and the whole state, count included, stay bit for bit as they were (the
JAX step's ``u · mask`` and ``jnp.where(do_step, new, old)``), and no value
goes to the host. ``torch.optim.Adam`` behind ``if gate.item()`` would
compute the same values, but syncs on every gate.

The gradients are concatenated into one flat fp32 tensor, the moments live
in one flat buffer each, and the update is computed in one more: the step
is a dozen elementwise ops on flat tensors, each the same per element as
optax's, plus one ``torch._foreach_add_`` of the update's per-param views
into the params. Per-param ``_foreach`` ops over the 188 tensors of the two
generators cost more host time than the device spends on the whole step's
arithmetic. :attr:`AdamState.mu` and :attr:`AdamState.nu` are the
per-param views of the moments.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


class AdamState:
    """``count`` (int32 device scalar) and the first and second moments,
    zero at init, one flat buffer each with a view per param; and the
    step's update buffer, whose views go into the params."""

    def __init__(self, params: Sequence[torch.Tensor]):
        dev = params[0].device
        n = sum(p.numel() for p in params)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.mu_flat, self.nu_flat, self.upd_flat = (
            torch.zeros(n, dtype=torch.float32, device=dev) for _ in range(3))
        # made once: the step writes the flat buffers in place
        self.mu, self.nu, self.upd = (self._views(f, params) for f in (
            self.mu_flat, self.nu_flat, self.upd_flat))

    @staticmethod
    def _views(flat: torch.Tensor, params: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
        out, o = [], 0
        for p in params:
            out.append(flat[o:o + p.numel()].view(p.shape))
            o += p.numel()
        return out


@torch.no_grad()
def adam_step(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              state: AdamState, lr: torch.Tensor, mask: torch.Tensor,
              b1: float = 0.5, b2: float = 0.999, eps: float = 1e-8,
              weight_decay: float = 0.0, injected: bool = True,
              mesh=None) -> None:
    """One masked Adam step, in place on ``params`` and ``state``. ``lr``
    is an fp32 device scalar, ``mask`` a device bool. ``injected`` takes
    ``1 − b`` in fp32 from fp32 ``b`` (``inject_hyperparams``), else
    rounds the Python float ``1 − b`` once; ``weight_decay`` adds
    ``weight_decay · p`` to the gradient first. ``mesh`` (data
    parallelism): the flat gradient is averaged over ranks first, one
    ``all_reduce`` (:mod:`cistar_tpu_torch.parallel.sharding`)."""
    from cistar_tpu_torch.parallel.sharding import all_reduce_mean

    f32 = np.float32
    if injected:
        c1, c2 = float(f32(1) - f32(b1)), float(f32(1) - f32(b2))
    else:
        c1, c2 = float(f32(1 - b1)), float(f32(1 - b2))
    b1, b2, eps = (float(f32(v)) for v in (b1, b2, eps))
    g = all_reduce_mean(torch.cat([t.reshape(-1) for t in grads]).float(),
                        mesh)
    if weight_decay:
        g = g + float(f32(weight_decay)) * torch.cat(
            [p.detach().reshape(-1) for p in params])
    mu = c1 * g + b1 * state.mu_flat
    nu = c2 * (g * g) + b2 * state.nu_flat
    count = state.count + 1
    c = count.float()
    mu_hat = mu / (1 - torch.pow(b1, c))
    nu_hat = nu / (1 - torch.pow(b2, c))
    upd = mu_hat / (torch.sqrt(nu_hat) + eps)
    torch.mul(upd * -lr, mask.float(), out=state.upd_flat)
    torch._foreach_add_(list(params), state.upd)
    state.mu_flat.copy_(torch.where(mask, mu, state.mu_flat))
    state.nu_flat.copy_(torch.where(mask, nu, state.nu_flat))
    state.count.copy_(torch.where(mask, count, state.count))
