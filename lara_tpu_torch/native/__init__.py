"""Native (C++) runtime components of the port, built with g++.

The port's own copy of the host libraries: ``blossom`` (exact maximum-weight
matching, the ``-m 0`` matcher; ``reference/src/matching.hpp:201-238``),
``lagrange_host`` (the hybrid backend's per-pair bookkeeping), ``baseline``
(the native single-thread solve) and ``model_build`` (the interaction
models).  Shared libraries are compiled on first use into
``lara_tpu_torch/_build/native/`` and rebuilt when a source is newer.  A
build writes a temporary file and renames it into place, so processes that
build the same library at once never load a partial one.  A failed build
raises :class:`NativeBuildError`.
"""

from __future__ import annotations

import os
import subprocess
import threading

_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
_LIB_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "native")
_BUILD_LOCK = threading.Lock()


class NativeBuildError(RuntimeError):
    pass


def shared_library(name: str, extra_sources: tuple = ()) -> str:
    """Path to the compiled shared library for ``src/<name>.cpp`` (plus any
    ``extra_sources`` linked into the same object), building it if any source
    is newer or no build exists yet."""
    sources = [os.path.join(_SRC_DIR, f"{name}.cpp")] + [
        os.path.join(_SRC_DIR, f"{extra}.cpp") for extra in extra_sources
    ]
    target = os.path.join(_LIB_DIR, f"lib{name}.so")
    with _BUILD_LOCK:
        if os.path.exists(target) and all(
            os.path.getmtime(target) >= os.path.getmtime(src)
            for src in sources
        ):
            return target
        os.makedirs(_LIB_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [
            "g++", "-std=c++17", "-O2", "-fPIC", "-shared",
            "-o", tmp, *sources,
        ]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise NativeBuildError(f"cannot build {name}: {exc}") from exc
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise NativeBuildError(
                f"g++ failed for {name}:\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, target)
        return target
