"""Shared re-export helper for the contrib namespaces."""
from ..ops.registry import registered_ops as _registered_ops

_PREFIX = "_contrib_"


def populate(namespace, source_module, all_list):
    """Bind every registered ``_contrib_*`` op from ``source_module`` into
    ``namespace`` under its reference short name (MultiBoxPrior, fft, ...)."""
    for name in _registered_ops():
        if not name.startswith(_PREFIX):
            continue
        short = name[len(_PREFIX):]
        fn = getattr(source_module, name, None)
        if fn is None or short in namespace:
            continue
        namespace[short] = fn
        all_list.append(short)
