"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
placed in `build/diskrag_tpu_torch/` beside the package and loaded with
`ctypes`. A library is rebuilt only when the hash of its source, of the
shared headers (`csrc/*.cuh`) and of the build flags changes. All stale sources are compiled together, one
`nvcc` process each, so the first call pays for the slowest file only.

The host tier's record reader (`native/<name>.cpp`, no CUDA) is built the
same way by the host C++ compiler (`load_host`), into the same directory,
keyed by the hash of its source and flags.

Every C entry point returns `cudaGetLastError()` after its launches;
`check()` raises on a non-zero code, because a launch CUDA refused
(too many threads, too much shared memory) never runs and a later
`torch.cuda.synchronize()` would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
NATIVE = pathlib.Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = (
    pathlib.Path(__file__).resolve().parents[2] / "build" / "diskrag_tpu_torch"
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per-source compiler reports of this process's builds (-Xptxas -v:
# registers, shared memory, spills)
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (pathlib.Path(root) / "bin" / "nvcc").exists():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(src: pathlib.Path, defines: tuple[str, ...] = ()) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include any header
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + _define_flags(defines)).encode())
    tag = "".join(f"-{d.lower()}" for d in defines)
    return BUILD_DIR / f"{src.stem}{tag}-{h.hexdigest()[:16]}.so"


def _define_flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return tuple(f"-D{d}" for d in defines)


def _compile(jobs: dict[str, tuple[pathlib.Path, pathlib.Path, tuple[str, ...]]]) -> None:
    """Run nvcc on every (source, library, defines) of `jobs` at once."""
    nvcc = _nvcc()
    procs = {}
    for stem, (src, out, defines) in jobs.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[stem] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *_define_flags(defines), "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, out,
        )
    failed = []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[stem] = log
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build_all() -> dict[str, pathlib.Path]:
    """Compile every stale `csrc/*.cu` in parallel; returns {stem: path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {s.stem: (s, _lib_path(s)) for s in sorted(CSRC.glob("*.cu"))}
    stale = {k: (src, out, ()) for k, (src, out) in targets.items() if not out.exists()}
    if stale:
        _compile(stale)
    return {k: v[1] for k, v in targets.items()}


def load(stem: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for `csrc/<stem>.cu`, building all stale
    sources on the first call. With `defines` (macro names, each passed as
    -D), a separate library of that source alone built with them: a
    measurement build, such as G1's stage clock, never the default one."""
    with _lock:
        key = ":".join((stem, *defines))
        lib = _libs.get(key)
        if lib is None and defines:
            src = CSRC / f"{stem}.cu"
            out = _lib_path(src, defines)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                _compile({key: (src, out, defines)})
            lib = _libs[key] = ctypes.CDLL(str(out))
        elif lib is None:
            paths = build_all()
            for name, path in paths.items():
                if name not in _libs:
                    _libs[name] = ctypes.CDLL(str(path))
            lib = _libs[stem]
        return lib


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "c++", "g++"):
        if name and shutil.which(name):
            return shutil.which(name)
    raise RuntimeError("no host C++ compiler found: set CXX or put g++ on PATH")


def host_lib_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def load_host(stem: str) -> ctypes.CDLL:
    """The loaded library for `native/<stem>.cpp`, compiled by the host
    C++ compiler on the first call (and whenever its source changed).
    Raises when the compiler is missing or fails: the caller asked for
    the native path."""
    key = f"native/{stem}"
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            src = NATIVE / f"{stem}.cpp"
            out = host_lib_path(src)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(src)],
                                      capture_output=True, text=True)
                build_logs[key] = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"{src.name} failed to build:\n{build_logs[key]}")
                os.replace(tmp, out)
            lib = _libs[key] = ctypes.CDLL(str(out))
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
