"""Optimizers and learning-rate schedules on `torch.optim`.

The registered optimizers (Adamax, Adam, SGD) and schedulers
(WarmUpScheduler, Constant) take the JAX package's config keys.  The
schedule is a pure function of the optimizer's own update count, which
starts at 0, is saved in the optimizer state and is NOT the trainer's step
(the two differ after a resume that realigns the step):

    lr(count) = base_lr * min(1, (epoch + 1) / warmup) * beta^(epoch + 1 - warmup)
    epoch = count // step_per_epoch

The schedule stays a host function of the count, in float32 as the JAX
package evaluates it.  A step of K updates first writes lr(count) ..
lr(count + K - 1) into a device tensor of its own (`next_lrs`: one
non-blocking copy from pinned memory, no sync), each update reads its
element (`update(lr)`), and the step then advances the count by K
(`advance`).  So a step captured as a CUDA graph reads each replay's
learning rates from that tensor instead of baking in the ones it was
captured with.  On the card the torch optimizers are `capturable`: the
learning rate is a device tensor and the per-parameter step counters live
on the device.  Adamax (max(|g| + eps, b2 * nu)) and Adam are optax's
algebra; SGD is the package's own (`SGD`: torch.optim.SGD takes its
learning rate as a host number), with optax's rounding.  `grad_clip_norm`
clips as optax's `clip_by_global_norm` does -- g * max_norm / ||g|| when
||g|| >= max_norm, with no epsilon -- and not as
`torch.nn.utils.clip_grad_norm_`, which divides by ||g|| + 1e-6.  Neither
the clip nor the update syncs with the host.
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
        # over thousands of epochs carries float32(beta)'s rounding.  The
        # power of the float32 operands is rounded once from float64;
        # XLA's float32 pow agrees with that within 2 ulps (numpy's own
        # float32 power differs from it more often)
        e1 = f32(count // step_per_epoch + 1)
        power = f32(np.power(np.float64(f32(beta)),
                             np.float64(e1 - f32(warmup))))
        return float(f32(base_lr) * np.minimum(f32(1), e1 / f32(warmup))
                     * power)

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


def _lr0(capturable: bool, params):
    """The initial learning rate: a device tensor for a capturable
    optimizer (each update points the groups at its own element)."""
    if capturable:
        return torch.zeros((), device=params[0].device)
    return 0.0


@OPTIMIZERS.register(name="Adamax")
def adamax(params, capturable=False, **kw):
    return torch.optim.Adamax(params, lr=_lr0(capturable, params),
                              capturable=capturable, **_betas(kw))


@OPTIMIZERS.register(name="Adam")
def adam(params, capturable=False, **kw):
    return torch.optim.Adam(params, lr=_lr0(capturable, params),
                            capturable=capturable, **_betas(kw))


class SGD(torch.optim.Optimizer):
    """optax's sgd (momentum as `optax.trace`, optionally Nesterov), with a
    learning rate that may be a device tensor, so that its update captures
    in a CUDA graph (torch.optim.SGD reads its learning rate on the host).
    Each update rounds as optax does: p - lr * g, the trace g + m * t."""

    def __init__(self, params, lr=0.0, momentum=None, nesterov=False):
        super().__init__(params, {"lr": lr, "momentum": momentum or 0.0,
                                  "nesterov": nesterov})

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr, m = group["lr"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if m:
                    st = self.state[p]
                    if "momentum_buffer" not in st:
                        st["momentum_buffer"] = torch.zeros_like(p)
                    buf = st["momentum_buffer"]
                    buf.copy_(g + m * buf)
                    g = g + m * buf if group["nesterov"] else buf
                p.sub_(lr * g)


@OPTIMIZERS.register(name="SGD")
def sgd(params, capturable=False, **kw):
    return SGD(params, lr=_lr0(capturable, params), **kw)


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
    optional global-norm clip in front.  `capturable` (the torch
    optimizer's): the learning rate and the step counters on the device."""

    def __init__(self, inner: torch.optim.Optimizer,
                 schedule: Callable[[int], float], grad_clip_norm=None,
                 capturable: bool = False):
        self.inner = inner
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.capturable = capturable
        self.count = 0
        # K -> the [K] learning rates of a step of K updates
        self._lrs: Dict[int, torch.Tensor] = {}

    @property
    def params(self):
        return [p for g in self.inner.param_groups for p in g["params"]]

    def lr(self) -> float:
        """The learning rate of the next update."""
        return float(self.schedule(self.count))

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def next_lrs(self, K: int) -> torch.Tensor:
        """The learning rates of the next K updates, lr(count) ..
        lr(count + K - 1), written into the step's [K] float32 tensor on
        the parameters' device (the same tensor at every call) and
        returned."""
        host = torch.tensor([self.schedule(self.count + j) for j in range(K)],
                            dtype=torch.float32)
        lrs = self._lrs.get(K)
        if lrs is None:
            lrs = self._lrs[K] = torch.empty(K, device=self.params[0].device)
        if lrs.device.type == "cuda":
            host = host.pin_memory()
        lrs.copy_(host, non_blocking=True)
        return lrs

    def lrs(self, K: int) -> torch.Tensor:
        """The [K] tensor `next_lrs(K)` last filled (what a step's body
        reads)."""
        return self._lrs[K]

    def update(self, lr: torch.Tensor) -> None:
        """One update at lr (a 0-d element of `lrs`): the clip and the
        torch optimizer's step, device work only; the count is the
        caller's (`advance`)."""
        if self.grad_clip_norm:
            clip_by_global_norm_(
                [p.grad for p in self.params if p.grad is not None],
                self.grad_clip_norm)
        for group in self.inner.param_groups:
            # a host number off the card (reading a CPU tensor is no sync)
            group["lr"] = lr if self.capturable else float(lr)
        self.inner.step()

    def advance(self, K: int) -> None:
        self.count += K

    def step(self) -> None:
        """One update at lr(count), not captured."""
        self.update(self.next_lrs(1)[0])
        self.advance(1)

    def state_dict(self) -> Dict:
        """{"count": updates so far, "state": the torch optimizer's
        per-parameter state, keyed by position in the parameter order}."""
        return {"count": self.count,
                "state": self.inner.state_dict()["state"]}

    def load_state_dict(self, sd: Dict) -> None:
        """Moments go to their parameters' device.  The per-parameter step
        counters go where this optimizer keeps them, whichever form the
        state was saved in: on the parameters' device when it is
        capturable (torch moves them), else on the host (a counter on the
        card would cost the non-capturable update a host sync per
        parameter)."""
        groups = self.inner.state_dict()["param_groups"]
        state = {i: {k: (v.cpu() if k == "step" and not self.capturable
                         else v)
                     for k, v in st.items()}
                 for i, st in sd["state"].items()}
        self.inner.load_state_dict({"state": state, "param_groups": groups})
        self.count = int(sd["count"])


def build_optimizer(params, optimizer_cfg: dict, scheduler_cfg: dict,
                    step_per_epoch: int, capturable=None) -> Optimizer:
    """Combine optimizer + scheduler configs (YAML shape: optimizer: {name,
    lr, grad_clip_norm?, ...}, scheduler: {name, warmup, beta}).
    `capturable` defaults to whether the parameters are on the card."""
    params = list(params)
    if capturable is None:
        capturable = params[0].device.type == "cuda"
    ocfg = dict(optimizer_cfg)
    oname = ocfg.pop("name")
    base_lr = ocfg.pop("lr", ocfg.pop("learning_rate", 1e-3))
    grad_clip = ocfg.pop("grad_clip_norm", None)
    scfg = dict(scheduler_cfg or {"name": "Constant"})
    sname = scfg.pop("name")
    schedule = SCHEDULERS.get(sname)(
        base_lr=base_lr, step_per_epoch=step_per_epoch, **scfg
    )
    return Optimizer(
        OPTIMIZERS.get(oname)(params, capturable=capturable, **ocfg),
        schedule, grad_clip, capturable)
