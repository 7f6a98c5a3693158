"""On-demand builds of the package's native libraries.

Two shared libraries back the port, both compiled on first use into the
git-ignored `cniic_tpu_torch/_build/` directory and loaded with ctypes:

* the host C runtime, from `csrc/cniic_native.c` (the port's copy of the
  reference's one source file), with the system C compiler;
* the CUDA kernels under `csrc/`, with `nvcc` for `sm_90a`.

A library is rebuilt whenever one of its sources is newer than it. Each
build goes to a per-process temporary path and is renamed into place, so
concurrent fresh processes never load a half-written file. The compiler's
output of the last build is kept beside the library as `<name>.log` (the
kernel build runs with `-Xptxas -v`, so the log holds each kernel's
registers, shared memory and spills).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")

_lock = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def log_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}.log")


def _stale(out: str, sources) -> bool:
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(os.path.getmtime(s) > built for s in sources)


def _compile(name: str, sources, commands) -> None:
    """Run the first of `commands` (argv lists with "{out}" standing for the
    output path) that succeeds; raise with the compiler's output if none
    does."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = lib_path(name)
    tmp = f"{out}.{os.getpid()}.tmp"
    errors = []
    for argv in commands:
        argv = [tmp if a == "{out}" else a for a in argv]
        proc = subprocess.run(argv, capture_output=True, text=True)
        if proc.returncode == 0:
            with open(log_path(name), "w") as fh:
                fh.write(" ".join(argv) + "\n" + proc.stdout + proc.stderr)
            os.replace(tmp, out)
            return
        errors.append(f"$ {' '.join(argv)}\n{proc.stdout}{proc.stderr}")
    raise RuntimeError(f"building lib{name}.so failed:\n" + "\n".join(errors))


def load(name: str, sources, commands) -> ctypes.CDLL:
    """Build `lib<name>.so` from `sources` if it is missing or stale, then
    load it (once per process). Different libraries build concurrently when
    loaded from different threads."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _loaded.get(name)
        if lib is None:
            if _stale(lib_path(name), sources):
                _compile(name, sources, commands)
            lib = _loaded[name] = ctypes.CDLL(lib_path(name))
        return lib


def nvcc() -> str:
    """Path of the CUDA compiler: PATH first, then the toolkit's usual home."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are "
            "built from csrc/ on first use and need the CUDA toolkit")
    return path
