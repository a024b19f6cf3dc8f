"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` is compiled by ``nvcc`` on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with ``ctypes``.  The libraries go into ``.torch_ext_build/`` at the
root of the checkout, named by a hash of their sources and flags, so a
changed source rebuilds and an unchanged one loads at once.  Building
happens on first use, never at import: a host without ``nvcc`` can import
every module of the port.

``LAUNCHES`` counts kernel launches by kernel name, the backward kernels
under their own.  Each wrapper adds one where it launches its
kernel and nowhere else, so a run can show that it went through the
kernels.  ``refuse_grad`` is the guard of a kernel that has no backward
(decode attention).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / ".torch_ext_build"
SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "decode_attention.cu", "ssm_scan.cu",
           "ssm_scan_bwd.cu", "mlstm_scan.cu", "mlstm_scan_bwd.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

LAUNCHES = {"rmsnorm": 0, "flash_attention": 0, "decode_attention": 0, "ssm_scan": 0,
            "mlstm_scan": 0, "flash_attention_bwd": 0, "rmsnorm_bwd": 0, "ssm_scan_bwd": 0,
            "mlstm_scan_bwd": 0}

_FUNCS: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def refuse_grad(name: str, item: str, *tensors) -> None:
    """Raise where grad is enabled and an input of a kernel that has no
    backward requires it: returning its output would drop the gradient
    without a word (the output has no ``grad_fn``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward kernel: ROADMAP.md queue 2 item {item}. "
                           "Train this arch with use_kernels=False, or on the CPU")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source on first use")
    return found


def library_path(src: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update((CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{Path(src).stem}_{digest.hexdigest()[:16]}.so"


def build(*, ptxas_verbose: bool = False) -> dict[str, tuple[float, str]]:
    """Compile every source whose library is missing: one ``nvcc`` per
    source, all started together.  Returns ``{source: (seconds, log)}`` for
    the sources it built (the log holds ``-Xptxas -v`` output when asked)
    and raises with the compiler's message if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for src in SOURCES:
        out = library_path(src)
        if out.is_file():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC / src)]
        jobs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True), tmp, out)
    built, failed = {}, []
    for src, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{src}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)        # atomic: a concurrent loader sees all or nothing
        built[src] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return built


def function(src: str, name: str, argtypes: list, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``src``'s library, built if needed.
    Every launcher returns a CUDA error code (0 = success)."""
    key = (src, name)
    fn = _FUNCS.get(key)
    if fn is None:
        path = library_path(src)
        if not path.is_file():
            build()
        fn = getattr(ctypes.CDLL(str(path)), name)
        fn.argtypes = argtypes
        fn.restype = restype
        _FUNCS[key] = fn
    return fn


def check(src: str, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err:
        name = function(src, f"{Path(src).stem}_error_string", [ctypes.c_int], ctypes.c_char_p)
        raise RuntimeError(f"{what}: CUDA error {err} ({name(err).decode()})")
