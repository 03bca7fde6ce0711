"""``gluon.contrib`` (counterpart of ``mxnet_tpu/gluon/contrib``):
``Concurrent`` layers and the estimator's fit loop."""
from . import estimator  # noqa: F401
from . import nn  # noqa: F401
