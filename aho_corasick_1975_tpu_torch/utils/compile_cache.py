"""The port's compile cache: the counterpart of ``utils/compile_cache.py``.

The JAX package turns on XLA's persistent compilation cache at scanner
construction, so that a second process reads compiled executables from
disk. The port compiles nothing at run time but its hand-written kernels,
once per source hash, into ``build/torch_kernels/`` (ops/build.py), which
already persists across processes. So ``enable_compile_cache`` keeps the
JAX function's contract (the process-wide latch, the ``ACX_COMPILE_CACHE``
opt-out, never raising) and reports that directory; it configures nothing
else. Both scanners call it at construction, as in JAX.
"""

from __future__ import annotations

import os

_done = False
_active: str | None = None   # the directory reported, if any


def enable_compile_cache(path: str | None = None,
                         enabled: bool = True) -> str | None:
    """The port's kernel build directory (``path``, else
    ops/build.BUILD_DIR), or None when disabled; idempotent: repeat calls
    report the first call's outcome. ``ACX_COMPILE_CACHE=off`` (or "0",
    "no", "false") disables it."""
    global _done, _active
    if _done:
        return _active
    _done = True
    if not enabled or not _enabled():
        return None
    from ..ops.build import BUILD_DIR
    _active = path or BUILD_DIR
    return _active


def _enabled() -> bool:
    return os.environ.get("ACX_COMPILE_CACHE", "").lower() not in (
        "off", "0", "no", "false")
