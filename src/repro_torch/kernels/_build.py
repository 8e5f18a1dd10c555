"""Build and load the port's CUDA kernels.

All ``repro_torch/csrc/*.cu`` sources are compiled for ``sm_90a`` by
``nvcc`` (one process per source, all started together), linked into one
shared library with a plain C interface, and loaded with ``ctypes``.  The
library lives in ``<repo>/build/`` under a name that carries a hash of the
sources, so a checkout builds it once, at its first kernel launch, and a
changed source builds anew.  Nothing is built on import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import fallback

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
# how many times this process compiled the kernel library (each build runs
# nvcc on every source); a checkout whose library exists builds 0 times
BUILDS = 0


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def source_tag() -> str:
    """Hash of every kernel source and header."""
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels unless this source hash is built already.

    Returns the path of the shared library.  The compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside it as
    ``build_<tag>.log``.
    """
    tag = source_tag()
    lib = BUILD_DIR / f"librepro_torch_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    global BUILDS
    BUILDS += 1
    work = Path(tempfile.mkdtemp(prefix=f"{tag}-", dir=BUILD_DIR))
    try:
        srcs = sorted(CSRC.glob("*.cu"))
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
             str(work / f"{src.stem}.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in srcs]
        logs, failed = [], []
        try:
            for src, p in zip(srcs, procs):
                out, _ = p.communicate()
                logs.append(f"== {src.name}\n{out}")
                if p.returncode:
                    failed.append(src.name)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        log = "\n".join(logs)
        (BUILD_DIR / f"build_{tag}.log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = work / lib.name
        res = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *[str(work / f"{s.stem}.o") for s in srcs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}")
        os.replace(tmp_lib, lib)      # atomic: concurrent builds agree
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def call(name: str, argtypes, *args) -> None:
    """Call the C entry ``name`` and raise if it reports a CUDA error.

    Every pointer and the stream must be declared ``ctypes.c_void_p`` in
    ``argtypes``, or ctypes would pass them as 32-bit ints.
    """
    lib = library()
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}: "
                           f"{lib.repro_error_string(err).decode()}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def kernel_device(*tensors) -> str:
    """'cpu' when every tensor lies on the CPU, 'cuda' when every tensor
    lies on one card; anything else raises (no silent copies)."""
    devs = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type


def guarded(family: str, launch, ref=None):
    """Run a wrapper's call under ``fallback.guarded(family)``.  On the CPU
    ``launch`` is None and the plain version ``ref`` stands in for the
    kernel (and is what a demoted family runs); on the card the kernels are
    built first, so a build failure raises, and ``launch`` runs with no
    plain version to give way to: a fault raises."""
    if launch is None:
        return fallback.guarded(family, ref, ref)
    library()
    return fallback.guarded(family, launch)


def require(cond: bool, msg: str) -> None:
    """Raise ValueError with ``msg`` unless ``cond`` (kernel input checks)."""
    if not cond:
        raise ValueError(msg)
