"""The estimator's event handlers (counterpart of
``mxnet_tpu/gluon/contrib/estimator/event_handler.py``): the six event
bases and the handlers for stopping, the gradient update, metrics,
logging, validation, checkpoints and early stopping.  Host code over the
estimator's trainer, metrics and net; ``CheckpointHandler`` writes the
reference's file names (``<prefix>-<tag>.params`` / ``.states``), whose
``.params`` either package loads."""
from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as onp

__all__ = ["TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd", "BatchBegin",
           "BatchEnd", "StoppingHandler", "CheckpointHandler",
           "EarlyStoppingHandler", "LoggingHandler", "ValidationHandler",
           "MetricHandler", "GradientUpdateHandler"]


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop after max_epoch / max_batch."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0
        # epochs=0 / batches=0 means "train nothing", not "train forever"
        if (self.max_epoch is not None and self.max_epoch <= 0) or \
                (self.max_batch is not None and self.max_batch <= 0):
            estimator.stop_training = True

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch is not None and self.current_batch >= self.max_batch:
            estimator.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch is not None and self.current_epoch >= self.max_epoch:
            estimator.stop_training = True


class GradientUpdateHandler(BatchEnd):
    """Applies the optimizer step after backward (override it to change
    the update, e.g. to accumulate gradients).  Priority -2000: before
    the metrics."""

    priority = -2000

    def batch_end(self, estimator, *args, **kwargs):
        estimator.trainer.step(estimator._batch_size)


class MetricHandler(EpochBegin, BatchEnd):
    """Updates the train metrics from the last batch.  Priority -1000:
    after the gradient update, before user handlers read the metrics."""

    priority = -1000

    def __init__(self, metrics=None):
        self.metrics = metrics

    def epoch_begin(self, estimator, *args, **kwargs):
        for m in (self.metrics or estimator.train_metrics):
            m.reset()
        estimator.train_loss_metric.reset()

    def batch_end(self, estimator, *args, **kwargs):
        estimator.train_loss_metric.update(None, estimator._batch_loss)
        for m in (self.metrics or estimator.train_metrics):
            m.update([estimator._batch_label], [estimator._batch_pred])


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchEnd):
    """Periodic metric logging."""

    def __init__(self, log_interval="epoch", metrics=None):
        self.log_interval = log_interval
        self.metrics = metrics
        self.batch_index = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        logging.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        t = time.time() - self.train_start
        logging.info("Train finished using total %ds", int(t))

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()
        self.batch_index = 0

    def epoch_end(self, estimator, *args, **kwargs):
        t = time.time() - self.epoch_start
        msgs = []
        for m in (self.metrics or estimator.train_metrics):
            name, val = m.get()
            msgs.append(f"{name}: {val:.4f}")
        logging.info("Epoch[%d] finished in %.2fs: %s",
                     self.current_epoch, t, ", ".join(msgs))
        self.current_epoch += 1

    def batch_end(self, estimator, *args, **kwargs):
        self.batch_index += 1
        if isinstance(self.log_interval, int) and \
                self.batch_index % self.log_interval == 0:
            msgs = []
            for m in (self.metrics or estimator.train_metrics):
                name, val = m.get()
                msgs.append(f"{name}: {val:.4f}")
            logging.info("Epoch[%d] Batch[%d]: %s", self.current_epoch,
                         self.batch_index, ", ".join(msgs))


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Run validation every epoch (or every N batches)."""

    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None,
                 priority=-1000):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0
        self.priority = priority

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self.eval_fn(val_data=self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.eval_fn(val_data=self.val_data)


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Saves the parameters (and the trainer's states) periodically, the
    last ``max_checkpoints`` kept, and the best by a monitored metric."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 verbose=0, save_best=False, mode="auto", epoch_period=1,
                 batch_period=None, max_checkpoints=5,
                 resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.max_checkpoints = max_checkpoints
        self.current_epoch = 0
        self.current_batch = 0
        self.saved = []
        if mode == "min" or (mode == "auto" and monitor is not None
                             and "loss" in monitor.get()[0]):
            self._initial_best = onp.inf
            self.better = lambda a, b: a < b
        else:
            self._initial_best = -onp.inf
            self.better = lambda a, b: a > b
        self.best = self._initial_best

    def train_begin(self, estimator, *args, **kwargs):
        os.makedirs(self.model_dir, exist_ok=True)
        # full reset so a reused handler doesn't compare run 2 against
        # run 1's best or keep rotating run 1's files
        self.current_epoch = 0
        self.current_batch = 0
        self.saved = []
        self.best = self._initial_best

    def _save(self, estimator, tag, rotate=True):
        prefix = os.path.join(self.model_dir, f"{self.model_prefix}-{tag}")
        estimator.net.save_parameters(prefix + ".params")
        if estimator.trainer is not None:
            estimator.trainer.save_states(prefix + ".states")
        if not rotate:      # the single 'best' file never enters rotation
            return
        self.saved.append(prefix)
        while len(self.saved) > self.max_checkpoints:
            old = self.saved.pop(0)
            for suffix in (".params", ".states"):
                try:
                    os.remove(old + suffix)
                except OSError:
                    pass

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self._save(estimator, f"batch{self.current_batch}")

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self._save(estimator, f"epoch{self.current_epoch}")
        if self.save_best and self.monitor is not None:
            _, val = self.monitor.get()
            if self.better(val, self.best):
                self.best = val
                self._save(estimator, "best", rotate=False)


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stop when the monitored metric stops improving."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        name = monitor.get()[0] if monitor is not None else ""
        if mode == "min" or (mode == "auto" and "loss" in name):
            self.better = lambda a, b: a < b - self.min_delta
            self._initial_best = onp.inf if baseline is None else baseline
        else:
            self.better = lambda a, b: a > b + self.min_delta
            self._initial_best = -onp.inf if baseline is None else baseline
        self.best = self._initial_best

    def train_begin(self, estimator, *args, **kwargs):
        # full reset so a second fit() doesn't compare against the last run
        self.wait = 0
        self.current_epoch = 0
        self.stopped_epoch = 0
        self.best = self._initial_best

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        _, val = self.monitor.get()
        if self.better(val, self.best):
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self.current_epoch
                estimator.stop_training = True

    def train_end(self, estimator, *args, **kwargs):
        if self.stopped_epoch:
            logging.info("Early stopping at epoch %d", self.stopped_epoch)
