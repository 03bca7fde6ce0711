"""``mxnet_tpu_torch.models.vision`` under MXNet's path
``mx.gluon.model_zoo.vision``."""
from ...models.vision import *          # noqa: F401,F403
from ...models.vision import get_model, _models  # noqa: F401
