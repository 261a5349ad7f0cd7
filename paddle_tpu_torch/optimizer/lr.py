"""LR schedulers (counterpart of ``paddle_tpu/optimizer/lr.py``).

Host-side step counters with Paddle's ``scheduler.step()`` contract:
``__call__`` returns the current learning rate, a Python float.  The
constructor takes the first ``step()`` (``last_epoch`` -1 → 0), as in the
reference.  ``verbose`` logs each new rate through this module's logger
(the reference prints it).
"""

from __future__ import annotations

import logging
import math
from typing import Callable, List, Optional

_log = logging.getLogger(__name__)


class LRScheduler:
    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1,
                 verbose: bool = False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self) -> float:
        return self.last_lr

    def step(self, epoch: Optional[int] = None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()
        if self.verbose:
            _log.info("Epoch %d: set learning rate to %s.", self.last_epoch,
                      self.last_lr)

    def get_lr(self) -> float:
        raise NotImplementedError

    def state_dict(self):
        """The scheduler's plain-valued attributes (ints, floats, bools,
        strings, lists)."""
        return {k: v for k, v in self.__dict__.items()
                if isinstance(v, (int, float, bool, str, list))}

    def set_state_dict(self, state_dict):
        self.__dict__.update(state_dict)

    set_dict = set_state_dict
    state_keys = state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model, self.warmup_steps = d_model, warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        a = step ** -0.5
        b = self.warmup_steps ** -1.5 * step
        return self.base_lr * (self.d_model ** -0.5) * min(a, b)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries: List[int], values: List[float],
                 last_epoch=-1, verbose=False):
        self.boundaries, self.values = list(boundaries), list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps, self.end_lr = decay_steps, end_lr
        self.power, self.cycle = power, cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        decay_steps = self.decay_steps
        if self.cycle:
            div = math.ceil(step / decay_steps) if step > 0 else 1
            decay_steps = decay_steps * div
        else:
            step = min(step, decay_steps)
        return (self.base_lr - self.end_lr) * \
            (1 - step / decay_steps) ** self.power + self.end_lr


class LinearWarmup(LRScheduler):
    """Linear from ``start_lr`` to ``end_lr`` over ``warmup_steps``, then
    ``learning_rate``: a float, or a scheduler stepped to ``last_epoch -
    warmup_steps``."""

    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        sched = isinstance(learning_rate, LRScheduler)
        self.lr_sched = learning_rate if sched else None
        self.final_lr = 0 if sched else learning_rate
        self.warmup_steps, self.start_lr, self.end_lr = \
            warmup_steps, start_lr, end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * \
                self.last_epoch / self.warmup_steps + self.start_lr
        if self.lr_sched is not None:
            self.lr_sched.step(self.last_epoch - self.warmup_steps)
            return self.lr_sched()
        return self.final_lr


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones, self.gamma = list(milestones), gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size, self.gamma = step_size, gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda: Callable[[int], float],
                 last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def state_dict(self):
        return {k: v for k, v in super().state_dict().items()
                if k != "lr_lambda"}


class MultiplicativeDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        cur = self.base_lr
        for e in range(1, self.last_epoch + 1):
            cur *= self.lr_lambda(e)
        return cur

    def state_dict(self):
        return {k: v for k, v in super().state_dict().items()
                if k != "lr_lambda"}


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max, self.eta_min = T_max, eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate, max_learning_rate, step_size_up,
                 step_size_down=None, mode="triangular", exp_gamma=1.0,
                 scale_fn=None, scale_mode="cycle", last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.step_up = step_size_up
        self.step_down = step_size_down or step_size_up
        self.mode, self.exp_gamma = mode, exp_gamma
        self.scale_fn, self.scale_mode = scale_fn, scale_mode
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.step_up + self.step_down
        cycle = math.floor(1 + self.last_epoch / total)
        x = self.last_epoch - (cycle - 1) * total
        frac = x / self.step_up if x <= self.step_up else \
            1 - (x - self.step_up) / self.step_down
        amp = (self.max_lr - self.base_lr) * frac
        if self.scale_fn is not None:
            sc = self.scale_fn(cycle if self.scale_mode == "cycle"
                               else self.last_epoch)
        elif self.mode == "triangular2":
            sc = 1 / (2 ** (cycle - 1))
        elif self.mode == "exp_range":
            sc = self.exp_gamma ** self.last_epoch
        else:
            sc = 1.0
        return self.base_lr + amp * sc


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        self.three_phase = three_phase   # kept, not read, as the reference
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _anneal(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return (end - start) * pct + start

    def get_lr(self):
        step = min(self.last_epoch, self.total_steps)
        up = int(self.phase_pct * self.total_steps)
        if step <= up:
            return self._anneal(self.initial_lr, self.max_lr,
                                step / max(up, 1))
        return self._anneal(self.max_lr, self.end_lr,
                            (step - up) / max(self.total_steps - up, 1))


class ReduceOnPlateau(LRScheduler):
    """Cuts the rate by ``factor`` once the metric passed to ``step()`` has
    not improved for more than ``patience`` calls.  Its constructor takes
    no first step."""

    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode, self.factor, self.patience = mode, factor, patience
        self.threshold, self.threshold_mode = threshold, threshold_mode
        self.cooldown, self.min_lr, self.epsilon = cooldown, min_lr, epsilon
        self.cooldown_counter = 0
        self.best = None
        self.num_bad_epochs = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0
        self.verbose = verbose

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        self.last_epoch += 1
        if metrics is None:
            return
        current = float(metrics.item() if hasattr(metrics, "item")
                        else metrics)
        if self.best is None or self._better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
                if self.verbose:
                    _log.info("Epoch %d: reducing lr to %s.", self.last_epoch,
                              new_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0

    def _better(self, a, b):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < b * (1 - self.threshold)
            return a < b - self.threshold
        if self.threshold_mode == "rel":
            return a > b * (1 + self.threshold)
        return a > b + self.threshold
