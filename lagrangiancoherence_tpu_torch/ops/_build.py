"""Build the package's CUDA kernels with ``nvcc`` at first use.

The sources under ``ops/csrc/*.cu`` (with the shared ``*.cuh`` headers)
expose a plain C interface.  Each is compiled by its own ``nvcc``, all
started together, and the objects are linked into one shared library that
is loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
The library lands in ``build/kernels/`` at the repository root, named by a
hash of the sources and the flags, so a fresh checkout builds on its first
call and an edited source rebuilds.  Nothing is ever downloaded, and a
failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

__all__ = ["NVCC_FLAGS", "SIGNATURES", "build", "load_library"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# never --use_fast_math: the kernels rely on IEEE division and rounding
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_GATHER_ARGTYPES = [_PTR, _PTR, _PTR, _PTR, _PTR,       # raw coeffs px py out
                    _INT, _INT, _INT, _INT, _INT,       # ny nx rows cols row_off
                    _INT, _INT, _LL,                    # order nf f0
                    ctypes.c_double, ctypes.c_double,   # x_min x_den
                    ctypes.c_double, ctypes.c_double,   # y_min y_den
                    _PTR]                               # stream
# coeffs folds out flags overflow y0map x0map live sel count, n_slots ny nx
# ny_t nx_t order nf f0 wy wx bit stage_bytes, stream
_TILE_ARGTYPES = [_PTR] * 10 + [_INT] * 7 + [_LL] + [_INT] * 4 + [_PTR]
# coeffs folds out flags overflow y0map x0q live, n_tiles ny nx ny_t nx_t
# order nf f0 wy bit stage_bytes, stream
_SUB_ARGTYPES = [_PTR] * 8 + [_INT] * 7 + [_LL] + [_INT] * 3 + [_PTR]
# raw pack ys out flags overflow sel count, n_slots ny nx nf f0 wy bit, stream
_POLE_ARGTYPES = [_PTR] * 8 + [_INT] * 4 + [_LL] + [_INT] * 2 + [_PTR]
SIGNATURES = {
    **{f"spline_gather_{t}": _GATHER_ARGTYPES for t in ("f32", "f64")},
    **{f"tile_window_gather_{t}": _TILE_ARGTYPES for t in ("f32", "f64")},
    **{f"sub_window_gather_{t}": _SUB_ARGTYPES for t in ("f32", "f64")},
    **{f"pole_window_gather_{t}": _POLE_ARGTYPES for t in ("f32", "f64")},
}


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, on PATH "
                       "and in /usr/local/cuda/bin): the CUDA kernels "
                       "cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"liblcs_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the sources if their library is missing.

    Returns (library path, seconds spent compiling — 0.0 when it already
    existed, nvcc's messages including ptxas' register and spill report).
    """
    lib = library_path()
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log_path.read_text() if log_path.exists() else ""
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    tmp = lib.with_name(f"{tag}.so.tmp")
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]   # wait for every one
    if all(proc.returncode == 0 for proc in procs):
        cmds.append([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
        procs.append(subprocess.run(cmds[-1], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
        outs.append(procs[-1].stdout)
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    log = "".join(outs)
    log_path.write_text(log)
    os.replace(tmp, lib)   # atomic: a concurrent build loads a whole file
    return lib, seconds, log


@lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
