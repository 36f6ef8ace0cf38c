"""Learning-rate schedulers of the PyTorch port: a copy of
``mxtpu/lr_scheduler.py`` (host-only; the port may not import it).
FactorScheduler / MultiFactorScheduler / PolyScheduler, called by the
Optimizer with ``num_update``.
"""
from __future__ import annotations

import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler"]


class LRScheduler:
    """Base: maps ``num_update`` to a learning rate. The optimizer
    overwrites ``base_lr`` with its own learning_rate at creation."""

    # mutable progress fields each scheduler carries across steps; a
    # checkpointed trainer round-trips exactly these so a resumed run
    # continues the schedule instead of restarting it (the factor
    # schedulers decay *relative to the decays already applied*, so
    # losing ``count`` would silently re-run the whole decay ladder)
    _STATE_FIELDS = ("base_lr",)

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError

    def state_dict(self):
        """Mutable schedule progress as plain python (checkpointable)."""
        return {f: getattr(self, f) for f in self._STATE_FIELDS}

    def load_state_dict(self, state):
        for f in self._STATE_FIELDS:
            if f in state:
                setattr(self, f, state[f])


class FactorScheduler(LRScheduler):
    """Geometric decay: one ``factor`` multiplication per completed
    ``step``-update window, floored at ``stop_factor_lr``."""

    _STATE_FIELDS = ("base_lr", "count")

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("step windows must span >= 1 update")
        if factor > 1.0:
            raise ValueError("a decay factor cannot exceed 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0          # updates consumed by applied decays

    def __call__(self, num_update):
        # apply one decay per fully elapsed window since the last call
        while num_update > self.count + self.step:
            self.count += self.step
            decayed = self.base_lr * self.factor
            if decayed < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("Update[%d]: lr floored at %0.5e",
                             num_update, self.base_lr)
            else:
                self.base_lr = decayed
                logging.info("Update[%d]: lr decayed to %0.5e",
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """One ``factor`` multiplication at each listed update milestone."""

    _STATE_FIELDS = ("base_lr", "count", "cur_step_ind")

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of milestones")
        if any(s < 1 for s in step) or \
                any(b >= a for a, b in zip(step[1:], step)):
            raise ValueError("milestones must be ascending and >= 1")
        if factor > 1.0:
            raise ValueError("a decay factor cannot exceed 1")
        self.step = step
        self.cur_step_ind = 0   # next milestone to fire
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind < len(self.step) and \
                num_update > self.step[self.cur_step_ind]:
            self.count = self.step[self.cur_step_ind]
            self.cur_step_ind += 1
            self.base_lr *= self.factor
            logging.info("Update[%d]: lr decayed to %0.5e", num_update,
                         self.base_lr)
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay to zero over ``max_update`` steps:
    lr(t) = lr0 * (1 - t/max_update)^pwr."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError("max_update must be a positive integer")
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.power = pwr

    def __call__(self, num_update):
        t = min(num_update, self.max_update) / float(self.max_update)
        self.base_lr = self.base_lr_orig * (1.0 - t) ** self.power
        return self.base_lr
