"""Version stamping (spark_rapids_jni_version.cpp.in analog; a copy of the JAX
package's ``version.py``).

The reference configures build info into a compiled translation unit at
cmake time; here the static version lives in code (kept in sync with
pyproject.toml) and volatile build info (git commit) is resolved lazily so
importing never shells out.
"""

from __future__ import annotations

import functools
import os
import subprocess

__all__ = ["VERSION", "__version__", "build_info"]

# kept in sync with pyproject.toml; the reference stamps 24.06.0-SNAPSHOT
# (pom.xml:24) the same way via spark_rapids_jni_version.cpp.in
VERSION = "26.08.0"
__version__ = VERSION


@functools.lru_cache(maxsize=1)
def build_info() -> dict:
    """Static version plus best-effort git commit of the source tree."""
    info = {"version": VERSION, "commit": "unknown"}
    try:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = subprocess.run(
            ["git", "-C", root, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
        )
        if out.returncode == 0:
            info["commit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return info
