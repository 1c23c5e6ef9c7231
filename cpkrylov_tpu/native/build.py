"""On-demand build of the native runtime library (ctypes-loaded).

Compiles every ``*.cpp`` in this directory into one shared library the
first time it is needed.  The library's file name carries a hash of the
sources, the compiler flags and the host CPU as ``-march=native`` resolves
it, so a library built from other sources or for another CPU is never
loaded: a change to any of them builds a new one.  Libraries live in ``_lib/`` beside the
sources, which git ignores.  A build failure raises with the compiler's
error output.  The native layer plays the role MATLAB's built-in native
code (ldl / sparse backslash) plays for the reference — see SURVEY.md §2.3.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_DIR = os.path.join(_DIR, "_lib")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_handle = None


def _sources() -> list[str]:
    return sorted(os.path.join(_DIR, f) for f in os.listdir(_DIR)
                  if f.endswith((".cpp", ".h")))


@functools.cache
def _host_cpu() -> str:
    """Every target option g++ enables for ``-march=native`` on this host."""
    proc = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True, check=True)
    return proc.stdout


def library_key(sources=None, flags=FLAGS) -> str:
    """Hash of the source contents, compiler flags and host CPU."""
    h = hashlib.sha256()
    for path in (sources if sources is not None else _sources()):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    h.update(_host_cpu().encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(_LIB_DIR, f"libcpk_native-{library_key()}.so")


def build() -> str:
    """Compile the sources into ``library_path()``; raise on failure."""
    lib = library_path()
    os.makedirs(_LIB_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.partial"   # concurrent builders never share
    cpp = [s for s in _sources() if s.endswith(".cpp")]
    proc = subprocess.run(["g++", *FLAGS, "-o", tmp, *cpp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"native library build failed (g++ exit {proc.returncode}):\n"
            f"{proc.stderr}")
    os.replace(tmp, lib)     # atomic: a reader never sees a partial file
    return lib


def load() -> ctypes.CDLL:
    """Build (when no library matches the current key) and load it."""
    global _handle
    with _LOCK:
        if _handle is None:
            lib = library_path()
            if not os.path.exists(lib):
                build()
            _handle = ctypes.CDLL(lib)
        return _handle
