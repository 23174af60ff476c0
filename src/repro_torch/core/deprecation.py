"""Once-per-process deprecation warnings for the v1 entry points.

The v2 API (``repro.platform.Platform`` + ``repro.core.compile`` +
``decide``) fronts the stack; the v1 call shapes keep working as thin shims
that emit a :class:`DeprecationWarning` exactly once per process per shim —
loud enough to steer migrations, quiet enough that reference-path test
sweeps (thousands of calls) stay readable.
"""
from __future__ import annotations

import warnings
from typing import Set

_seen: Set[str] = set()


def warn_once(key: str, message: str, *, stacklevel: int = 3) -> bool:
    """Emit ``message`` as a DeprecationWarning the first time ``key`` is
    seen; later calls are no-ops.  Returns True when the warning fired."""
    if key in _seen:
        return False
    _seen.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)
    return True


def reset() -> None:
    """Forget every emitted warning (tests only)."""
    _seen.clear()
