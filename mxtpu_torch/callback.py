"""Training callbacks of the PyTorch port (``mxtpu/callback.py``'s
``module_checkpoint``, ``do_checkpoint``, ``log_train_metric`` and
``Speedometer``)."""
from __future__ import annotations

import logging
import time

from .model import save_checkpoint

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer"]


def _every(period):
    """True on the 0-indexed epochs whose (epoch + 1) is a multiple."""
    period = max(1, int(period))
    return lambda epoch: (epoch + 1) % period == 0


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving ``mod``'s checkpoint every ``period``."""
    due = _every(period)

    def _callback(epoch, sym=None, arg=None, aux=None):
        if due(epoch):
            mod.save_checkpoint(prefix, epoch + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving symbol and params every ``period``."""
    due = _every(period)

    def _callback(epoch, sym, arg, aux):
        if due(epoch):
            save_checkpoint(prefix, epoch + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the training metric every ``period``
    batches."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Log samples/s and the metric every ``frequent`` batches (reading
    the metric is the one host sync it costs)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._timing = False        # a window is open since self.tic
        self.tic = 0.0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if count < self.last_count:
            self._timing = False    # a new epoch restarted the count
        self.last_count = count
        if not self._timing:
            self._timing = True
            self.tic = time.time()
            return
        if count % self.frequent:
            return
        speed = self.frequent * self.batch_size / (time.time() - self.tic)
        metric = param.eval_metric
        if metric is not None:
            pairs = metric.get_name_value()
            if self.auto_reset:
                metric.reset()
            tail = "".join("\t%s=%f" % nv for nv in pairs)
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                         param.epoch, count, speed, tail)
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self.tic = time.time()
