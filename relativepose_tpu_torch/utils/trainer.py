"""Epoch trainer with time-boxed train/val phases.

A copy of `relativepose_tpu/utils/trainer.py` (plain Python).  The
original trainer alternates a 5-minute training phase and a
1-minute validation phase per "epoch" (factory.py:20-24: trainDuration=300,
trainTestRatio=5), calling `model.step(data, mode)` and firing callbacks.
Here `step_fn(batch, mode) -> metrics` plays that role, batches come from
any iterable factory, and phase budgets are configurable.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Optional, Sequence

from relativepose_tpu_torch.utils.callbacks import (
    Callback,
    CallbackLoc,
    run_callbacks,
)
from relativepose_tpu_torch.utils.log import AverageMeter, colored_log


@dataclasses.dataclass
class Trainer:
    step_fn: Callable          # (batch, mode) -> dict of metrics
    train_loader: Iterable
    val_loader: Iterable
    max_epoch: int = 200
    train_duration: float = 300.0   # factory.py:20
    train_test_ratio: int = 5       # factory.py:21
    callbacks: Sequence[Callback] = ()
    epoch: int = 0
    # agree(go) -> go on every rank: data-parallel ranks end a time-boxed
    # phase at the same step (`train/mesh.py::all_agree`)
    agree: Optional[Callable[[bool], bool]] = None
    verbose: bool = True

    def _go_on(self, start, budget):
        go = time.time() - start < budget
        return go if self.agree is None else self.agree(go)

    def _phase(self, loader, mode: str, budget: float, context):
        meter = AverageMeter()
        start = time.time()
        it = iter(loader)
        n = 0
        while self._go_on(start, budget):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(loader)
                try:
                    batch = next(it)
                except StopIteration:
                    break
            run_callbacks(self.callbacks, CallbackLoc.batch_start, context)
            metrics = self.step_fn(batch, mode)
            if metrics and "loss" in metrics:
                meter.update(float(metrics["loss"]))
            n += 1
            context["global_step"] = context.get("global_step", 0) + 1
            run_callbacks(self.callbacks, CallbackLoc.batch_end, context)
        if self.verbose:
            colored_log(
                f"[{mode}] ", f"epoch {self.epoch}: {n} steps, "
                f"avg loss {meter.avg:.6f}")
        return meter.avg

    def run(self):
        context = {"trainer": self, "epoch": self.epoch, "global_step": 0}
        run_callbacks(self.callbacks, CallbackLoc.train_start, context)
        try:
            while self.epoch < self.max_epoch:
                context["epoch"] = self.epoch
                run_callbacks(self.callbacks, CallbackLoc.epoch_start, context)
                context["train_loss"] = self._phase(
                    self.train_loader, "train", self.train_duration, context)
                context["val_loss"] = self._phase(
                    self.val_loader, "val",
                    self.train_duration / self.train_test_ratio, context)
                self.epoch += 1
                context["epoch"] = self.epoch
                run_callbacks(self.callbacks, CallbackLoc.epoch_end, context)
        except Exception:
            run_callbacks(self.callbacks, CallbackLoc.exception, context)
            raise
        finally:
            run_callbacks(self.callbacks, CallbackLoc.train_end, context)
        return context
