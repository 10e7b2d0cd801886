"""Builds the port's CUDA kernels with ``nvcc`` at first use and loads them.

Every ``antmmf_torch/ops/csrc/*.cu`` file compiles (all at once, one ``nvcc``
each) for ``sm_90a`` into an object file, and the objects link into one shared
library with a plain C interface, loaded with ``ctypes``. The library's name
carries a hash of the sources and flags, so an edited source never loads a
stale build. Output goes to ``build/antmmf_torch_kernels/`` at the repository
root, which git ignores. ``nvcc`` is found on ``PATH`` or under
``$CUDA_HOME/bin`` (default ``/usr/local/cuda``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "antmmf_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "port's CUDA kernels are built with it at first use")


def _run_all(cmds, log):
    """Start every command at once, wait for all, raise on the first failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode and failed is None:
            failed = (cmd, out)
    if failed:
        raise RuntimeError(f"nvcc failed: {' '.join(failed[0])}\n{failed[1]}")


def build() -> str:
    """Compile and link the kernels unless this exact build exists; return
    the library's path. The compiler's report (registers, shared memory,
    spills) is kept beside it as ``<library>.log``."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(os.path.basename(src).encode() + f.read())
    lib_path = os.path.join(BUILD_DIR, f"libantmmf_torch_kernels-{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    log: list = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s)[:-3] + ".o") for s in sources]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o]
                  for s, o in zip(sources, objs)], log)
        tmp_lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                   "-o", tmp_lib, *objs]], log)
        with open(lib_path + ".log", "w") as f:
            f.write("\n".join(log))
        os.replace(tmp_lib, lib_path)  # atomic: a reader never sees half a file
    return lib_path


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call, with argument types set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn = lib.antmmf_small_attention_fwd
            fn.argtypes = [p, p, p, p, p, i, i, i, i, ll, ll, ll, ll, ll, ll,
                           ctypes.c_float, i, p]
            fn.restype = i
            lib.antmmf_cuda_error_string.argtypes = [i]
            lib.antmmf_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib
