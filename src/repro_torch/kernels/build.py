"""Build the CUDA sources under `csrc/` with nvcc and bind them with ctypes.

Each source is compiled on first use into its own shared library with a
plain C interface (`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`), named by a hash of the source so an edited kernel is
rebuilt, under `build/kernels/` at the root of the checkout.  Nothing is
compiled when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# C entry points of each source and their argument types: "p" a pointer or
# the stream (c_void_p), "i" an int (c_int), "f" a float (c_float).  Every
# entry returns the cudaError_t of its launch.
SIGNATURES = {
    "frontier_scan": {"frontier_scan_f32": "pppppppiiiiiiip",
                      "frontier_scan_sq8": "pppppppppiiiiiiip",
                      "frontier_scan_excl_f32": "pppppppppppfiiiiiiip",
                      "frontier_scan_excl_sq8": "pppppppppppppfiiiiiiip"},
    "distance": {"distance_matrix_f32": "pppiiiip"},
    "leaf_scan": {"leaf_scan_batched_f32": "pppppppppiiiiiip",
                  "leaf_scan_f32": "ppppppppiiiiiiiip"},
    "topk": {"topk_f32": "ppppiiip"},
    "flash_attention": {"flash_attention": "ppppiiiiiiiip",
                        "flash_attention_wgmma": "ppppiiiiiiip"},
}

_LOADED: dict[str, ctypes.CDLL] = {}
# Launches of each kernel since the last reset: each CUDA wrapper adds one
# right after its kernel launched, and nothing else touches the counts.
LAUNCHES = {"frontier_scan": 0, "distance_matrix": 0, "leaf_scan_batched": 0,
            "frontier_scan_sq8": 0, "frontier_scan_excl": 0,
            "frontier_scan_excl_sq8": 0, "leaf_scan": 0, "topk": 0,
            "flash_attention": 0}
# Launches by route, for a kernel with more than one: "<kernel>.<route>",
# counted beside the kernel's total in LAUNCHES.
ROUTES = {"flash_attention.wgmma": 0, "flash_attention.fma": 0}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _lib_path(name: str, src_dir=CSRC, out_dir=BUILD_DIR) -> pathlib.Path:
    src = (pathlib.Path(src_dir) / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return pathlib.Path(out_dir) / f"lib{name}-{digest[:12]}.so"


def _start_build(name: str, src_dir=CSRC, out_dir=BUILD_DIR):
    """Start nvcc for one source; returns (process, tmp path, final path),
    or None when the library is already built."""
    out = _lib_path(name, src_dir, out_dir)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           str(pathlib.Path(src_dir) / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=tuple(SIGNATURES), src_dir=CSRC,
              out_dir=BUILD_DIR) -> float:
    """Compile every named source of `src_dir` into `out_dir`, all nvcc
    processes running at once.  Returns the wall seconds the build took
    (0 when all were built)."""
    t0 = time.perf_counter()
    started = {n: _start_build(n, src_dir, out_dir) for n in names}
    errors = []
    for n, s in started.items():
        if s is None:
            continue
        try:
            _finish_build(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load_from(src_dir, name: str, out_dir) -> ctypes.CDLL:
    """The bound library of `<src_dir>/<name>.cu` (another checkout's copy
    of a source, for example), built into `out_dir` when it is not built
    yet.  Binds each entry point of SIGNATURES[name] that the library
    exports: an older source may lack a newer entry."""
    started = _start_build(name, src_dir, out_dir)
    if started is not None:
        _finish_build(name, started)
    lib = ctypes.CDLL(str(_lib_path(name, src_dir, out_dir)))
    for fn, sig in SIGNATURES[name].items():
        if hasattr(lib, fn):
            f = getattr(lib, fn)
            f.argtypes = [_CTYPES[c] for c in sig]
            f.restype = ctypes.c_int
    return lib


def load(name: str) -> ctypes.CDLL:
    """The bound library of `csrc/<name>.cu`, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = load_from(CSRC, name, BUILD_DIR)
    return lib


def check(status: int, what: str, route: str | None = None) -> None:
    """Raise when a C entry point reports a failed launch; count it when it
    launched, and under its route when the kernel has several."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
    LAUNCHES[what] += 1
    if route is not None:
        ROUTES[f"{what}.{route}"] += 1


def metric_code(metric: str, kernel: str) -> int:
    """The kernels' metric argument: 0 for L2, 1 for inner product."""
    codes = {"l2": 0, "ip": 1}
    if metric not in codes:
        raise NotImplementedError(f"{kernel} kernel: metric {metric!r}")
    return codes[metric]


def require(t, dtype, shape, name: str) -> None:
    """Check one kernel argument: a contiguous CUDA tensor of this dtype
    and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
