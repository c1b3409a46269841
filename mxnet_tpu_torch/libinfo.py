"""Library-location helper (reference python/mxnet/libinfo.py
``find_lib_path``); counterpart of ``mxnet_tpu/libinfo.py``.  The port's
native libraries are built at first use into ``_build/`` beside the
package, each named by a hash of its sources and flags: the C ABI
(``libmxtpu_torch_capi-*``, ``native.capi_lib_path``), the RecordIO reader
and the JPEG codecs (``native``), and the attention kernels
(``kernels``)."""
from __future__ import annotations

import glob
import os

__version__ = "0.9.5-torch"


def find_lib_path():
    """Paths of the port's native libraries that are built on disk, the C
    ABI's first; an empty list when none is built yet."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
    found = sorted(glob.glob(os.path.join(build, "*.so")))
    return sorted(found, key=lambda p: not os.path.basename(p).startswith(
        "libmxtpu_torch_capi-"))
