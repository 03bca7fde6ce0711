"""``mx.onnx`` — ONNX export/import (counterpart of
``mxnet_tpu/onnx/__init__.py``).

- :func:`export_model` traces a Gluon block with ``torch.export`` and
  emits standard ONNX through the port's own wire codec
  (:mod:`.proto`; no ``onnx`` package is needed).
- :func:`import_model` loads an ONNX file into a callable that runs it
  with torch ops.

Files cross between this package and the reference both ways.
"""
from .mx2onnx import export_model
from .onnx2mx import ONNXBlock, import_model

__all__ = ["export_model", "import_model", "ONNXBlock"]
