"""Learning-rate schedules (port of the JAX ``train/schedulers.py``).

Each is a function of the optimizer's own step count (0 on the first
update) returning the learning rate as a float.
"""
from __future__ import annotations


def warmup_lr(lr: float, warmup_steps: int = 25000):
    """WarmupLR: inverse-sqrt decay with warmup; exactly ``lr`` at step ==
    warmup_steps (step 0 counts as step 1)."""

    def sched(step: int) -> float:
        s = float(max(step, 1))
        return lr * warmup_steps ** 0.5 * min(s ** -0.5,
                                              s * warmup_steps ** -1.5)

    return sched


def steady_lr(lr: float, warmup_steps: int = 25000):
    """SteadyLR: linear ramp to lr over warmup_steps, then constant."""

    def sched(step: int) -> float:
        return lr * min(1.0, (step + 1.0) / warmup_steps)

    return sched


def noam_hold_annealing(lr: float, warmup_steps: int, hold_steps: int,
                        max_steps: int, decay_rate: float = 0.5,
                        min_lr: float = 0.0):
    """NeMo-style Noam + hold + polynomial annealing."""

    def sched(step: int) -> float:
        s = float(step)
        hold_end = warmup_steps + hold_steps
        if s < warmup_steps:
            return lr * s / max(warmup_steps, 1)
        if s < hold_end:
            return lr
        frac = min(max((s - hold_end) / max(max_steps - hold_end, 1), 0.0),
                   1.0)
        decayed = lr * (1.0 - frac) ** (1.0 / decay_rate) if decay_rate \
            else lr
        return max(decayed, min_lr)

    return sched


SCHEDULERS = {
    "warmuplr": warmup_lr,
    "steadylr": steady_lr,
}
