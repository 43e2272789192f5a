"""Optimizers and learning-rate schedules on `torch.optim`.

The registered optimizers (Adamax, Adam, SGD) and schedulers
(WarmUpScheduler, Constant) take the JAX package's config keys.  The
schedule is a pure function of the optimizer's own update count, which
starts at 0, is saved in the optimizer state and is NOT the trainer's step
(the two differ after a resume that realigns the step):

    lr(count) = base_lr * min(1, (epoch + 1) / warmup) * beta^(epoch + 1 - warmup)
    epoch = count // step_per_epoch

`Optimizer.step` sets every group's learning rate to lr(count) and then
runs the torch optimizer, whose Adamax (max(|g| + eps, b2 * nu)) and Adam
updates are optax's algebra.  `grad_clip_norm` clips as optax's
`clip_by_global_norm` does -- g * max_norm / ||g|| when ||g|| >= max_norm,
with no epsilon -- and not as `torch.nn.utils.clip_grad_norm_`, which
divides by ||g|| + 1e-6.  Neither the clip nor the schedule syncs with the
host.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import numpy as np
import torch

from ..registry import OPTIMIZERS, SCHEDULERS


def warmup_exp_schedule(
    base_lr: float, warmup: int, beta: float, step_per_epoch: int
) -> Callable[[int], float]:
    f32 = np.float32

    def schedule(count: int) -> float:
        # in float32, as the JAX package evaluates it: beta^(e1 - warmup)
        # over thousands of epochs carries float32(beta)'s rounding
        e1 = f32(count // step_per_epoch + 1)
        return float(f32(base_lr) * np.minimum(f32(1), e1 / f32(warmup))
                     * np.power(f32(beta), e1 - f32(warmup)))

    return schedule


@SCHEDULERS.register(name="WarmUpScheduler")
def warmup_scheduler(base_lr, step_per_epoch, warmup=10, beta=0.99):
    return warmup_exp_schedule(base_lr, warmup, beta, step_per_epoch)


@SCHEDULERS.register(name="Constant")
def constant_scheduler(base_lr, step_per_epoch):
    return lambda count: base_lr


def _betas(kw: dict) -> dict:
    """optax's b1/b2 keys -> torch's betas."""
    if "b1" in kw or "b2" in kw:
        kw["betas"] = (kw.pop("b1", 0.9), kw.pop("b2", 0.999))
    return kw


@OPTIMIZERS.register(name="Adamax")
def adamax(params, **kw):
    return torch.optim.Adamax(params, lr=0.0, **_betas(kw))


@OPTIMIZERS.register(name="Adam")
def adam(params, **kw):
    return torch.optim.Adam(params, lr=0.0, **_betas(kw))


@OPTIMIZERS.register(name="SGD")
def sgd(params, **kw):
    return torch.optim.SGD(params, lr=0.0, **kw)


def clip_by_global_norm_(grads: Iterable[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax's clip_by_global_norm, in place: returns the global norm."""
    grads = list(grads)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class Optimizer:
    """A torch optimizer driven by a schedule of its update count, with an
    optional global-norm clip in front."""

    def __init__(self, inner: torch.optim.Optimizer,
                 schedule: Callable[[int], float], grad_clip_norm=None):
        self.inner = inner
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.count = 0

    @property
    def params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    def lr(self) -> float:
        """The learning rate of the next update."""
        return float(self.schedule(self.count))

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.grad_clip_norm:
            clip_by_global_norm_(
                [p.grad for p in self.params if p.grad is not None],
                self.grad_clip_norm)
        lr = self.lr()
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1

    def state_dict(self) -> Dict:
        """{"count": updates so far, "state": the torch optimizer's
        per-parameter state, keyed by position in the parameter order}."""
        return {"count": self.count,
                "state": self.inner.state_dict()["state"]}

    def load_state_dict(self, sd: Dict) -> None:
        """Moments go to their parameters' device; the per-parameter step
        counters stay on the host, where torch keeps them (a counter on the
        card would cost a host sync per parameter per update)."""
        groups = self.inner.state_dict()["param_groups"]
        state = {i: {k: (v.cpu() if k == "step" else v)
                     for k, v in st.items()}
                 for i, st in sd["state"].items()}
        self.inner.load_state_dict({"state": state, "param_groups": groups})
        self.count = int(sd["count"])


def build_optimizer(params, optimizer_cfg: dict, scheduler_cfg: dict,
                    step_per_epoch: int) -> Optimizer:
    """Combine optimizer + scheduler configs (YAML shape: optimizer: {name,
    lr, grad_clip_norm?, ...}, scheduler: {name, warmup, beta})."""
    ocfg = dict(optimizer_cfg)
    oname = ocfg.pop("name")
    base_lr = ocfg.pop("lr", ocfg.pop("learning_rate", 1e-3))
    grad_clip = ocfg.pop("grad_clip_norm", None)
    scfg = dict(scheduler_cfg or {"name": "Constant"})
    sname = scfg.pop("name")
    schedule = SCHEDULERS.get(sname)(
        base_lr=base_lr, step_per_epoch=step_per_epoch, **scfg
    )
    return Optimizer(OPTIMIZERS.get(oname)(list(params), **ocfg), schedule,
                     grad_clip)
