"""Plain train step of the flow: the published loss (mean negative
log-likelihood in nats per dim), autograd through the straight-through
rounding, an optional global-norm clip, and Adamax under the published
warm-up schedule, all in plain float32 PyTorch.  Imports nothing of the
package under test.

Adamax (Kingma & Ba): m = b1 m + (1 - b1) g, u = max(b2 u, |g| + eps),
p -= lr / (1 - b1^t) * m / u.  Schedule (`WarmUpScheduler`):
lr(count) = base * min(1, (e + 1) / warmup) * beta^(e + 1 - warmup) with
e = count // step_per_epoch, in float32.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .flow import Arch, Flow, nll, tf32_mode


def warmup_lr(count: int, base: float, warmup: int, beta: float,
              step_per_epoch: int) -> float:
    f32 = np.float32
    e1 = f32(count // step_per_epoch + 1)
    power = f32(np.power(np.float64(f32(beta)), np.float64(e1 - f32(warmup))))
    return float(f32(base) * np.minimum(f32(1), e1 / f32(warmup)) * power)


class PlainTrainer:
    """Steps a weight dict in place; keeps what the comparison reads."""

    def __init__(self, a: Arch, weights: Dict[str, torch.Tensor],
                 optimizer: dict, scheduler: dict, step_per_epoch: int,
                 precision: str = "float32", state: dict = None):
        """state: where to start instead of a fresh optimizer, {"m", "u"
        (Adamax's moments by leaf name), "count" (updates so far)}."""
        self.a, self.precision = a, precision
        self.params = {k: v.clone().requires_grad_(True)
                       for k, v in weights.items()}
        opt = dict(optimizer)
        if opt.pop("name") != "Adamax":
            raise ValueError("the plain step implements Adamax")
        self.base_lr = float(opt.pop("lr", 1e-3))
        self.b1, self.b2 = opt.pop("b1", 0.9), opt.pop("b2", 0.999)
        self.eps = 1e-8
        self.clip = opt.pop("grad_clip_norm", None)
        sch = dict(scheduler)
        sch.pop("name")
        self.warmup, self.beta = sch["warmup"], sch["beta"]
        self.step_per_epoch = step_per_epoch
        state = state or {"m": {}, "u": {}, "count": 0}
        self.m = {k: state["m"][k].to(v.device).clone() if k in state["m"]
                  else torch.zeros_like(v) for k, v in weights.items()}
        self.u = {k: state["u"][k].to(v.device).clone() if k in state["u"]
                  else torch.zeros_like(v) for k, v in weights.items()}
        self.count = int(state["count"])
        self.losses: List[float] = []
        self.first_grads: Dict[str, torch.Tensor] = {}

    def step(self, batch: torch.Tensor, chunks: int = 1) -> float:
        """One update on the batch: the loss is the batch's mean, and its
        gradient is taken over `chunks` equal slices of it (the mean of
        their gradients), which bounds the memory and is the same step."""
        flow = Flow(self.a, self.params, self.precision)
        names = list(self.params)
        leaves = [self.params[k] for k in names]
        loss, grads = 0.0, None
        with tf32_mode(flow.card_tf32):
            for part in batch.chunk(chunks):
                lc = nll(self.a, flow.forward(part)) / chunks
                gc = torch.autograd.grad(lc, leaves)
                loss = loss + lc.detach()
                grads = gc if grads is None else [g + h for g, h in
                                                  zip(grads, gc)]
        grads = dict(zip(names, grads))
        if self.clip:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            if float(norm) >= self.clip:
                grads = {k: g / norm * self.clip for k, g in grads.items()}
        if not self.first_grads:
            self.first_grads = {k: g.detach().clone()
                                for k, g in grads.items()}
        lr = warmup_lr(self.count, self.base_lr, self.warmup, self.beta,
                       self.step_per_epoch)
        self.count += 1
        corr = 1.0 - self.b1 ** self.count
        with torch.no_grad():
            for k in names:
                g = grads[k]
                self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                self.u[k] = torch.maximum(self.u[k] * self.b2,
                                          g.abs() + self.eps)
                self.params[k].sub_(lr / corr * self.m[k] / self.u[k])
        self.losses.append(float(loss))
        return self.losses[-1]
