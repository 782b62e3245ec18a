"""D-Adaptation Adam (Defazio & Mishchenko, ICML 2023).

The reference trains with `dadaptation.DAdaptAdam(parameters,
decouple=True)` (vamb/encode.py:578); this is `vamb_tpu/optim/dadapt.py`'s
update rule, with its flat state:

    dlr      = d * lr
    num'     = sqrt(b2) * num + (1-sqrt(b2)) * dlr * sum <g, s / (sqrt(v)+eps)>
    m'       = b1 * m + (1-b1) * dlr * g          (dlr folded into m)
    v'       = b2 * v + (1-b2) * g^2
    s'       = sqrt(b2) * s + (1-sqrt(b2)) * dlr * g
    d_hat    = num' / ((1-sqrt(b2)) * ||s'||_1)
    d'       = max(d, min(d_hat, d * growth_rate))     [kept if ||s'||_1 == 0]
    update   = -m' / (sqrt(v')+eps)  -  decay * dlr * p

There is no bias correction. d and the numerator are global scalars over
all parameters, and m, v, s are single flat vectors over the parameters in
the order given, so the global sums are one reduction each. In
data-parallel training `grad_reduce` sums the flat gradient over the ranks
(in rank order) before the update, so every rank updates its replica of
the parameters alike.
"""

from typing import Callable, Optional

import torch


class DAdaptAdam:
    """The update rule above over a list of parameters, with the interface
    of a torch optimizer that the trainer uses (`zero_grad`, `step`).

    A plain class, not a `torch.optim.Optimizer`: constructing the first
    Optimizer imports torch._dynamo, seconds of host time that this
    single-group rule has no use for."""

    def __init__(
        self,
        params,
        lr: float = 1.0,
        betas: tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        d0: float = 1e-6,
        growth_rate: Optional[float] = None,
        grad_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ):
        self.params = list(params)
        self.grad_reduce = grad_reduce
        self.lr, self.eps, self.weight_decay = lr, eps, weight_decay
        self.betas, self.growth_rate = betas, growth_rate
        total = sum(p.numel() for p in self.params)
        dev = self.params[0].device
        self.m = torch.zeros(total, device=dev)
        self.v = torch.zeros(total, device=dev)
        self.s = torch.zeros(total, device=dev)
        self.d = torch.tensor(d0, dtype=torch.float32, device=dev)
        self.numerator = torch.tensor(0.0, dtype=torch.float32, device=dev)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def step(self) -> None:
        lr, eps, wd = self.lr, self.eps, self.weight_decay
        b1, b2 = self.betas
        sqrt_b2 = b2**0.5
        g = torch.cat([p.grad.reshape(-1) for p in self.params])
        if self.grad_reduce is not None:
            g = self.grad_reduce(g)
        dlr = self.d * lr

        # the numerator increment uses the previous s and v
        delta_num = torch.sum(g * (self.s / (torch.sqrt(self.v) + eps)))
        self.numerator = sqrt_b2 * self.numerator + (1 - sqrt_b2) * dlr * delta_num

        self.m = b1 * self.m + (1 - b1) * dlr * g
        self.v = b2 * self.v + (1 - b2) * g * g
        self.s = sqrt_b2 * self.s + (1 - sqrt_b2) * dlr * g

        sk_l1 = torch.sum(torch.abs(self.s))
        d_hat = self.numerator / ((1 - sqrt_b2) * torch.clamp_min(sk_l1, 1e-30))
        if self.growth_rate is not None:
            d_hat = torch.minimum(d_hat, self.d * self.growth_rate)
        if lr > 0:
            self.d = torch.where(sk_l1 > 0, torch.maximum(self.d, d_hat), self.d)

        flat = -self.m / (torch.sqrt(self.v) + eps)
        if wd != 0.0:
            flat = flat - wd * dlr * torch.cat([p.reshape(-1) for p in self.params])
        offset = 0
        for p in self.params:
            n = p.numel()
            p.add_(flat[offset : offset + n].view_as(p))
            offset += n
