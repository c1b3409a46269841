"""Model symbol builders of the port (counterpart of
``mxnet_tpu/models``)."""
from . import transformer  # noqa: F401
