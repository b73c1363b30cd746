"""Callback system for the trainer.

A copy of `relativepose_tpu/utils/callbacks.py` (plain Python)."""

from __future__ import annotations

import enum

from relativepose_tpu_torch.utils.log import callback_log


class CallbackLoc(enum.Enum):
    train_start = 0
    train_end = 1
    epoch_start = 2
    epoch_end = 3
    batch_start = 4
    batch_end = 5
    exception = 6


class Callback:
    def __init__(self, cb_loc: CallbackLoc, func, args=None, kwargs=None):
        self.cb_loc = cb_loc
        self.func = func
        self.args = args or ()
        self.kwargs = kwargs or {}


class PeriodicCallback(Callback):
    """Runs every `pstep` epochs (utils/callbacks.py:60-93)."""

    def __init__(self, cb_loc, pstep, func, args=None, kwargs=None):
        super().__init__(cb_loc, func, args, kwargs)
        self.pstep = pstep

    def run(self, context):
        epoch = context.get("epoch", 0)
        if epoch % self.pstep == 0:
            callback_log(
                f"periodic callback {self.func.__name__} @ epoch {epoch}")
            return self.func(context, *self.args, **self.kwargs)


class OnceCallback(Callback):
    """Runs once at its location (utils/callbacks.py:96-123)."""

    def __init__(self, cb_loc, func, args=None, kwargs=None):
        super().__init__(cb_loc, func, args, kwargs)
        self._done = False

    def run(self, context):
        if not self._done:
            self._done = True
            callback_log(f"once callback {self.func.__name__}")
            return self.func(context, *self.args, **self.kwargs)


class ScheduledCallback(Callback):
    """Runs at specific epochs (utils/callbacks.py:126-157)."""

    def __init__(self, cb_loc, schedule, func, args=None, kwargs=None):
        super().__init__(cb_loc, func, args, kwargs)
        self.schedule = set(schedule)

    def run(self, context):
        if context.get("epoch", 0) in self.schedule:
            callback_log(f"scheduled callback {self.func.__name__}")
            return self.func(context, *self.args, **self.kwargs)


def run_callbacks(callbacks, loc: CallbackLoc, context):
    for cb in callbacks:
        if cb.cb_loc == loc:
            cb.run(context)
