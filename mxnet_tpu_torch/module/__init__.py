"""Module training API — counterpart of ``mxnet_tpu/module/``:
``BaseModule``, ``Module`` over one or several contexts,
``BucketingModule``, ``SequentialModule``, ``PythonModule`` and
``PythonLossModule``."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
