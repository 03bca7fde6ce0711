"""The estimator's fit loop (counterpart of
``mxnet_tpu/gluon/contrib/estimator``)."""
from .estimator import Estimator  # noqa: F401
from .event_handler import (BatchBegin, BatchEnd, CheckpointHandler,  # noqa
                            EarlyStoppingHandler, EpochBegin, EpochEnd,
                            GradientUpdateHandler, LoggingHandler,
                            MetricHandler, StoppingHandler, TrainBegin,
                            TrainEnd, ValidationHandler)
