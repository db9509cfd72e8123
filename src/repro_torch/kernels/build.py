"""Builds the port's CUDA C++ kernels with ``nvcc`` and loads them with ctypes.

Every ``src/repro_torch/csrc/*.cu`` is compiled for ``sm_90a`` (one ``nvcc``
per source, all started together) and linked into one shared library with a
plain C interface, ``<repo>/build/repro_torch/libkernels-<sha>.so``, named
by a hash of the sources so that an edit rebuilds. Nothing is compiled
when this module is imported: the first ``load()`` builds. A failed build
raises.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _LL, _F, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, ctypes.c_int
# C entry points and their argument types; pointers and the stream are c_void_p.
SIGNATURES = {
    "cfg_combine": [_P, _P, _P, _LL, _F, _I, _I, _I, _I, _LL, _P],
    "cfg_combine_rowscale": [_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _LL, _P],
    "apg_combine": [_P, _P, _P, _P, _P, _LL, _LL, _F, _F, _F] + [_I] * 7 + [_P],
    "rmsnorm": [_P, _P, _P, _LL, _I, _F, _I, _I, _I, _I, _I, _P],
    "flash_attention": [_P] * 4 + [_I] * 7 + [_F, _I, _I, _P],
    "decode_attention": [_P] * 7 + [_I] * 9 + [_F, _I, _P],
    "paged_decode_attention": [_P] * 9 + [_I] * 13 + [_F, _I, _I, _P],
    "paged_decode_attention_shard": [_P] * 10 + [_I] * 13 + [_F, _I, _I, _P],
}
# dtype codes the C entry points take
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VEC = {torch.float32: 4, torch.bfloat16: 8}   # elements in one 16-byte access
NUM_SMS = 132                                 # an H100 SXM's streaming multiprocessors

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libkernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile the sources unless this version is built. -> (library, log);
    with ``verbose`` the log holds ``ptxas``'s register and spill report."""
    out = library_path()
    if out.exists():
        return out, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH, *FLAGS, *extra, "-c", str(src), "-o", str(obj)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for cmd, obj, proc in jobs:
            text, _ = proc.communicate()
            log.append(text)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = [nvcc, *ARCH, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in jobs)]
        res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(res.stdout)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{' '.join(link)}\n{res.stdout}")
        os.replace(tmp_lib, out)
    return out, "".join(log)


def load():
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.kernels_error_string.argtypes = [ctypes.c_int]
        lib.kernels_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors and for meta tensors
    (shapes without data: the dry-run's steps take the plain versions, as
    the CPU does); raises on a mix or on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds in ({"cpu"}, {"meta"}):
        return False
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on {sorted(str(t.device) for t in tensors)}: "
                         "need all on the CPU or all on one CUDA device")
    return True


def stream(t) -> int:
    """The handle of the current CUDA stream of ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_inputs(*tensors) -> None:
    """Raise unless every tensor is contiguous float32 or bfloat16."""
    for t in tensors:
        if t.dtype not in DTYPES:
            raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous tensors")


def check_aligned(*tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (the kernels'
    16-byte and TMA copies need it)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("kernel takes tensors that start on a 16-byte boundary")


def check(lib, name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.kernels_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")
