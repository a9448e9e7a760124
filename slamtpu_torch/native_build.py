"""Host copy of ``slamtpu/native_build.py`` (numpy only, code unchanged).

The port cannot import it from ``slamtpu``: ``slamtpu/__init__.py``
imports JAX, so any ``import slamtpu.<module>`` pulls JAX in, and the
GPU port runs where JAX is absent. The docstring below is the
original's.

Build-on-first-use helper for the native C++ batch decoders (native/*.cpp).

Shared objects are never committed (they are unreviewable and machine-
specific: -march=native). Artifacts are keyed by the SHA-256 of the source
bytes — ``lib<stem>-<hash>.so`` — so the loader can only ever dlopen the
binary produced from the exact current source; a stale or foreign ``.so``
is simply never looked up (cf. ADVICE round 1: mtime comparison could load
a planted binary with a newer timestamp).
"""
from __future__ import annotations

import hashlib
import logging
import os
import subprocess
from typing import Optional

log = logging.getLogger("slamtpu.native_build")

BUILD_TIMEOUT_S = 120


def build_from_source(
    src_path: str, stem: str, extra_flags: tuple = ()
) -> Optional[str]:
    """Compile ``src_path`` to ``lib<stem>-<srchash>.so`` next to the source.

    Returns the shared-object path, or None if the toolchain is unavailable
    or the build fails (callers fall back to the pure-Python decoders).
    """
    src_path = os.path.abspath(src_path)
    try:
        with open(src_path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError as e:
        log.warning("native source unreadable (%s): %s", src_path, e)
        return None
    so_path = os.path.join(
        os.path.dirname(src_path), f"lib{stem}-{digest}.so"
    )
    if os.path.exists(so_path):
        return so_path
    tmp_path = f"{so_path}.tmp.{os.getpid()}"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC",
        *extra_flags,
        "-o", tmp_path, src_path,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=BUILD_TIMEOUT_S)
        os.replace(tmp_path, so_path)  # atomic: concurrent builders converge
        return so_path
    except Exception as e:  # pragma: no cover - toolchain-dependent
        log.warning("native build failed (%s): %s", " ".join(cmd), e)
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        return None
