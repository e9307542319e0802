"""Optimizer and LR schedules (counterpart of
``vsearch_tpu/train/optim.py``, which builds them on optax).

``Optimizer`` is optax's ``chain(clip_by_global_norm, adamw)`` on
``torch.optim.AdamW``: the global norm of the gradients is computed
unclipped, gradients are scaled by ``max_norm / norm`` only where the norm
exceeds ``max_norm`` (optax's rule; ``clip_grad_norm_`` would divide by
``norm + 1e-6`` every time), and the learning rate of update ``t`` is
``schedule(t)`` at the count before the update, as optax's
``scale_by_learning_rate`` evaluates it (so a warmup's first update has lr
0). Weight decay skips biases and every LayerNorm's parameters, chosen by
module type (reference model_utils.py:19-30).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

Schedule = Callable[[int], float]


def get_schedule_linear(warmup_steps: int, total_steps: int,
                        learning_rate: float,
                        steps_shift: int = 0) -> Schedule:
    """Linear warmup then linear decay to ~0, floored at 1e-7 (reference
    model_utils.py:69-90)."""

    def schedule(step):
        step = step + steps_shift
        if step < warmup_steps:
            return learning_rate * step / max(1, warmup_steps)
        frac = (total_steps - step) / max(1.0, total_steps - warmup_steps)
        return learning_rate * max(frac, 1e-7 / learning_rate)

    return schedule


def get_schedule_cosine(warmup_steps: int, total_steps: int,
                        learning_rate: float) -> Schedule:
    """Linear warmup from 0, then cosine decay to 0 at ``total_steps``:
    ``optax.warmup_cosine_decay_schedule(0, lr, max(1, warmup),
    max(2, total))``'s formula (reference model_utils.py:93-110)."""
    warmup = max(1, warmup_steps)
    decay = max(2, total_steps) - warmup
    if decay <= 0:
        raise ValueError(
            f"cosine schedule needs total_steps > warmup_steps, got "
            f"{total_steps} <= {warmup}")

    def schedule(step):
        if step < warmup:  # optax's linear_schedule from 0 to lr
            frac = 1.0 - min(max(step, 0), warmup) / warmup
            return -learning_rate * frac + learning_rate
        t = min(step - warmup, decay)
        return learning_rate * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return schedule


def get_schedule_warmup(warmup_steps: int,
                        learning_rate: float) -> Schedule:
    """Warmup then constant (reference model_utils.py:114-125)."""

    def schedule(step):
        if step < warmup_steps:
            return learning_rate * step / max(1, warmup_steps)
        return learning_rate

    return schedule


def decay_groups(modules: Iterable[nn.Module]
                 ) -> Tuple[List[nn.Parameter], List[nn.Parameter]]:
    """(decayed, not decayed) parameters of ``modules``, each once: biases
    and the parameters of every ``nn.LayerNorm`` (BERT's and the VDR
    head's ``ln``) are not decayed."""
    seen, decay, no_decay = set(), [], []
    for module in modules:
        for sub in module.modules():
            for name, p in sub.named_parameters(recurse=False):
                if id(p) in seen:
                    continue
                seen.add(id(p))
                if isinstance(sub, nn.LayerNorm) or name == "bias":
                    no_decay.append(p)
                else:
                    decay.append(p)
    return decay, no_decay


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (f32), as
    ``optax.global_norm``."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """Global-norm clipping + AdamW with no-decay groups + a schedule,
    over the parameters of ``modules`` (f32)."""

    def __init__(self, modules: Iterable[nn.Module],
                 learning_rate: float = 2e-5, adam_eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 max_grad_norm: Optional[float] = 2.0,
                 schedule: Optional[Schedule] = None):
        decay, no_decay = decay_groups(modules)
        self.params = decay + no_decay
        self.max_grad_norm = max_grad_norm
        self.schedule = schedule or (lambda _step: learning_rate)
        groups = [{"params": decay, "weight_decay": weight_decay}]
        if no_decay:
            groups.append({"params": no_decay, "weight_decay": 0.0})
        self.adamw = torch.optim.AdamW(groups, lr=learning_rate,
                                       betas=(0.9, 0.999), eps=adam_eps)
        self.count = 0  # updates applied (optax's schedule count)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self) -> torch.Tensor:
        """Clip, set the lr for this update, apply AdamW. Returns the
        unclipped global norm (a device scalar)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        for p, g in zip(self.params, grads):
            p.grad = g
        norm = global_norm(grads)
        if self.max_grad_norm:
            # g * min(1, max / norm), on the device (no host sync)
            torch._foreach_mul_(grads, (self.max_grad_norm / norm)
                                .clamp(max=1.0))
        lr = float(self.schedule(self.count))
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1
        return norm

    def lr(self, count: Optional[int] = None) -> float:
        """The lr of update ``count`` (default: the last one applied)."""
        return float(self.schedule(self.count - 1 if count is None
                                   else count))

    def state_dict(self) -> Dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict):
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def get_optimizer(modules: Iterable[nn.Module], learning_rate=2e-5,
                  adam_eps: float = 1e-8, weight_decay: float = 0.0,
                  max_grad_norm: Optional[float] = 2.0,
                  schedule: Optional[Schedule] = None) -> Optimizer:
    """AdamW with no-decay param groups + optional global-norm clipping
    (the reference clips by hand in its train loop,
    train_ir.py:170-172)."""
    return Optimizer(modules, learning_rate=learning_rate,
                     adam_eps=adam_eps, weight_decay=weight_decay,
                     max_grad_norm=max_grad_norm, schedule=schedule)
