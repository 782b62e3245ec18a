"""Adam as optax writes it, the optimizer of TaxVamb's VAEVAE.

`vamb_tpu`'s VAEVAE trains with `optax.adam(1e-3, eps=1e-8)` (reference
semisupervised_encode.py:1048-1053), not D-Adaptation. This is optax's
`scale_by_adam` followed by `scale_by_learning_rate`, operation for
operation, so a lockstep with `vamb_tpu` stays tight (`torch.optim.Adam`
rounds its bias corrections differently):

    count' = count + 1
    m'     = (1 - b1) * g + b1 * m
    v'     = (1 - b2) * g**2 + b2 * v
    m_hat  = m' / (1 - b1**count')          (float32)
    v_hat  = v' / (1 - b2**count')
    p'     = p + (-lr) * (m_hat / (sqrt(v_hat) + eps))

In data-parallel training `grad_reduce` sums the flat gradient over the
ranks (in rank order) before the update, as `DAdaptAdam`'s does, so every
rank updates its replica of the parameters alike.
"""

from typing import Callable, Optional

import numpy as np
import torch


class Adam:
    "The update rule above over a list of parameters (`zero_grad`, `step`)."

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 grad_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.params = list(params)
        self.grad_reduce = grad_reduce
        self.lr, self.betas, self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        b1, b2 = self.betas
        self.count += 1
        # the bias corrections in float32, as optax forms them from an int32 count
        c = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(b1) ** c)
        bc2 = float(np.float32(1) - np.float32(b2) ** c)
        # a parameter outside the loss's graph (VAEVAE's joint decoder) has
        # no gradient: optax sees zeros there
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        if self.grad_reduce is not None:  # one flat gradient, summed over the ranks
            flat = self.grad_reduce(torch.cat([g.reshape(-1) for g in grads]))
            grads = [g.view_as(p) for g, p in zip(flat.split([p.numel() for p in self.params]),
                                                   self.params)]
        torch._foreach_mul_(self.m, b1)
        torch._foreach_add_(self.m, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.v, b2)
        torch._foreach_add_(self.v, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        m_hat = torch._foreach_div(self.m, bc1)
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(self.v, bc2)), self.eps)
        torch._foreach_add_(self.params, torch._foreach_mul(torch._foreach_div(m_hat, denom), -self.lr))
