"""Build the port's CUDA kernels into one shared library, at first use.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, into an object with a plain C interface; the objects are
linked into ``libkernels.so`` and loaded with ``ctypes``.  The build lands
in ``build/repro_torch/<hash>/`` at the root of the checkout, keyed by a
hash of the sources and flags, so a second process reuses it.  No
``--use_fast_math``: the kernels must round as IEEE f32 does.

A build needs ``nvcc`` (on ``PATH`` or under ``/usr/local/cuda/bin``) and
targets ``sm_90a`` (H100).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Optional, Sequence

__all__ = ["CSRC", "BUILD_ROOT", "build", "library", "kernel_function",
           "check", "build_log"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[pathlib.Path] = None
_functions: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _sources() -> Sequence[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Path of ``libkernels.so`` for the current sources, building if needed."""
    out_dir = BUILD_ROOT / _key()
    lib = out_dir / "libkernels.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    procs = []
    try:
        t0 = time.perf_counter()
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp / "libkernels.so"),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("linking libkernels.so failed:\n" + "\n".join(log))
        log.append(f"== build seconds {time.perf_counter() - t0:.3f}")
        (tmp / "build.log").write_text("\n".join(log))
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not lib.exists():   # lost a race only if the winner built it
                raise
    finally:
        for *_, proc in procs:   # never leave a compiler running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib, _lib_path
    with _lock:
        if _lib is None:
            _lib_path = build()
            lib = ctypes.CDLL(str(_lib_path))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def build_log() -> str:
    """nvcc's output (``-Xptxas -v`` register and spill report) of the build."""
    library()
    return (_lib_path.parent / "build.log").read_text()


def kernel_function(name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point of the library with its argument types declared
    (once per name).

    Pointers and the stream are ``ctypes.c_void_p``; every entry point
    returns the ``cudaError_t`` of its launch.
    """
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().repro_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} (error {err})")
