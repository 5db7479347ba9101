"""Build the CUDA kernels with `nvcc` at first use and bind them with ctypes.

Every `csrc/*.cu` exposes a plain C interface (`extern "C"`, pointers,
ints, a stream, an error code back), so no PyTorch header is compiled:
one `nvcc -c` per source, all started together, then one link into a
single shared library. The library's name carries a hash of the sources,
the headers they share (`csrc/*.cuh`) and the flags, so an edited source
or header is never served from a stale build. The
build lands in `kernels/build/` inside the package (ignored by git); a
process that finds the library there loads it without compiling.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine with no `nvcc` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", *ARCH_FLAGS]

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# C signature of every exported function: (argtypes, restype = int error)
SIGNATURES = {
    "repro_spmm_blocksparse_f32": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I,
                                   _I, _I, _I, _P],
    "repro_spmm_blocksparse_bf16": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I,
                                    _I, _I, _I, _P],
    "repro_spmm_blocksparse_config": [_I, _I, _I, _I, _I, _P],
    "repro_gram_f32": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _LL, _F, _I,
                       _I, _P],
    "repro_tsgemm_f32": [_P, _P, _P, _P, _LL, _I, _I, _F, _F, _I, _I, _P],
    "repro_flash_attention_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _F, _I, _P],
    "repro_flash_attention_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _I, _I, _F, _I, _P],
    "repro_flash_attention_bwd_f32": [_P] * 12 + [_I] * 7 + [_F, _I, _P],
    "repro_flash_attention_bwd_bf16": [_P] * 12 + [_I] * 7 + [_F, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu"))


def _digest(files: list[Path], flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for s in files:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def library_path(flags: list[str], csrc: Path = CSRC) -> Path:
    """Where the build of `csrc`'s sources and headers with `flags` is."""
    files = _sources(csrc) + sorted(csrc.glob("*.cuh"))
    return BUILD_DIR / f"librepro_kernels_{_digest(files, flags)}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently; return their output, or raise with
    the compiler's output of the first one that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [(c, p.communicate()[0], p.returncode)
            for c, p in zip(cmds, procs)]
    for cmd, out, rc in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    return [out for _, out, _ in outs]


def build(verbose: bool = False, defines: tuple[str, ...] = ()) -> Path:
    """Compile every csrc/*.cu (in parallel) and link them into one shared
    library; returns its path. Reuses an existing build of the same
    sources and flags. verbose prints ptxas's register and shared-memory
    report for every kernel. `defines` (macros passed as -D) build a
    variant under a name of its own, for a comparison on the card: the
    port's library (`lib()`) is built without any."""
    sources = _sources()
    flags = [*NVCC_FLAGS, *(f"-D{name}" for name in defines)]
    lib_path = library_path(flags)
    if lib_path.exists():
        return lib_path
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        ptxas = ["-Xptxas", "-v"] if verbose else []
        outs = _run_all([[nvcc, *flags, *ptxas, f"-I{CSRC}", "-c", str(s),
                          "-o", str(o)] for s, o in zip(sources, objs)])
        if verbose:
            print("".join(outs), flush=True)
        tmp_lib = Path(tmp) / lib_path.name
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                   *map(str, objs)]])
        os.replace(tmp_lib, lib_path)   # atomic: concurrent builds agree
    return lib_path


def load(path: Path) -> ctypes.CDLL:
    """The shared library at `path`, every exported function typed."""
    handle = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def device_and_stream(t) -> tuple[int, int]:
    """(device ordinal, raw cudaStream_t) of PyTorch's current stream on
    the tensor's device: every kernel launches there, unsynchronized."""
    import torch
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def aligned16(*tensors) -> bool:
    """Every tensor's data on a 16-byte boundary (float4 loads and
    16-byte copies need it)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
