"""Training callbacks of the PyTorch port (counterpart of
incubator_mxnet_tpu/callback.py): `Speedometer`, `ProgressBar`,
`LogValidationMetricsCallback` and `log_train_metric`.  The checkpoint
callbacks (`do_checkpoint`, `module_checkpoint`) wait for the `module`
API, which is not yet ported.

A batch-end callback receives an object with `.epoch`, `.nbatch` and
`.eval_metric` (`Module.fit`'s `BatchEndParam`).

`Speedometer` times the card's work, not the host's enqueue: torch
returns before the card finishes, so it reads the metric first (which
waits for the card) and synchronises, and only then takes the elapsed
time.  Its log lines are the JAX package's,
character for character.
"""
from __future__ import annotations

import logging
import time

import torch

__all__ = ["log_train_metric", "Speedometer", "ProgressBar",
           "LogValidationMetricsCallback"]


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the metric every `period` batches
    (ref: callback.log_train_metric)."""
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Log samples/sec (and the metric) every `frequent` batches
    (ref: callback.Speedometer)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = int(frequent)
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0.0
        self.last_count = 0
        self.last_speed = 0.0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False       # new epoch
        self.last_count = count

        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent != 0:
            return
        # the card's work up to now is done before the clock is read
        name_value = None
        if param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            if self.auto_reset:
                param.eval_metric.reset()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        elapsed = time.time() - self.tic
        speed = (self.frequent * self.batch_size / elapsed
                 if elapsed > 0 else float("inf"))
        self.last_speed = speed
        if name_value is not None:
            msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s" % (
                param.epoch, count, speed,
                "\t".join("%s=%f" % nv for nv in name_value))
        else:
            msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec" % (
                param.epoch, count, speed)
        logging.info(msg)
        self.tic = time.time()


class ProgressBar:
    """Text progress bar for a known batch count
    (ref: callback.ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    """Eval-end callback logging validation metrics
    (ref: callback.LogValidationMetricsCallback)."""

    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f",
                         param.epoch, name, value)
