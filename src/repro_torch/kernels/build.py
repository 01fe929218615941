"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use, into ``build/repro_torch/<hash>/`` under the checkout (a
directory ``.gitignore`` lists), keyed by a hash of the sources, so a
fresh checkout builds everything on its first kernel call. A failed
build raises; there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

# C entry points: name -> argtypes (every pointer and the stream are
# c_void_p; each returns the launch's cudaGetLastError() as an int)
SIGNATURES: Dict[str, List] = {
    "rt_pack": [_P, _P, _LL, _I, _I, _I, _P],
    "rt_append_kv": [_P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _I, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rt_unpack": [_P, _P, _LL, _I, _I, _I, _I, _I, _P],
    "rt_convert": [_P, _P, _LL, _I, _P],
    "rt_truncate": [_P, _P, _LL, _I, _I, _P],
    "rt_take_rows": [_P, _P, _I, _P, _I, _LL, _LL, _I, _I, _I, _I, _I, _I,
                     _P],
    "rt_packed_matmul": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rt_packed_matmul_batched": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _P],
    "rt_pmm_smem": [_I, _I],
    "rt_pmm_t_smem": [_I, _I, _I],
    "rt_kv_decode": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _I, _I, _I, _I, _I, _P],
    "rt_paged_attention": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rt_attend_smem": [_I, _I, _I, _I, _I],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class LaunchCount:
    """A plain launch counter: a wrapper adds one where it launches its
    kernel and nowhere else."""

    def __init__(self) -> None:
        self.n = 0


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def build() -> Path:
    """Compile the kernels unless a library for these sources exists;
    returns the library's path. The compilers' ``-Xptxas -v`` reports go
    to ``build.log`` beside it."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "librepro_kernels.so"
    if lib_path.exists():
        return lib_path
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp, src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o",
                   str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp, lib_path.name)
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
             *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        Path(tmp, "build.log").write_text("\n".join(log))
        out_dir.mkdir(parents=True, exist_ok=True)
        shutil.move(str(Path(tmp, "build.log")), out_dir / "build.log")
        # rename last: a present library is a complete one
        os.replace(tmp_lib, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def require(t, name: str, dtypes, op: str) -> None:
    """A kernel operand must be a contiguous CUDA tensor of one of
    ``dtypes`` on the current device; anything else raises (a CPU tensor
    never reaches a kernel wrapper: ``kernels.ops`` sends it to the plain
    version)."""
    import torch

    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{op}: {name} must be a CUDA tensor")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{op}: {name} is on {t.device}, not the current "
                         f"device cuda:{torch.cuda.current_device()}")
    if t.dtype not in dtypes:
        raise ValueError(f"{op}: {name} has dtype {t.dtype}, expected one "
                         f"of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def sm_count(t) -> int:
    return _sm_count(t.device.index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count
