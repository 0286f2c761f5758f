"""Build and load the CUDA kernels of ops/cuda/csrc.

The sources compile with nvcc into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds).  The library is built at first use into ``build/torch_kernels/``
of the checkout, under a name keyed by a hash of the sources and flags,
so an edited source is rebuilt and a stale library is never loaded.
Each source compiles in its own nvcc process, all started together, and
one more call links the objects:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC --split-compile=0
         -c csrc/<name>.cu -o <name>.o                        (one per source)
    nvcc -shared -o libxgpr_kernels_<hash>.so *.o

Each sincos kernel has one instantiation per mode (csrc/common.cuh), so
a source holds several large kernels; ``--split-compile=0`` optimises
them on all the host's cores, which halves the build on an 8-core host
(PERF.md).  The kernels also have one instantiation per body
(csrc/gemm_common.cuh: Format), each body in its own source so that their
nvcc processes run side by side: the 3xTF32 body in ``feature_map.cu``,
``ztzv.cu`` and ``conv.cu`` (with the C entry points; K1/K2's TMA
pipeline of ``dense_wgmma.cuh``, K3/K4's of ``conv_tf32.cuh``), the bf16
body in ``ztzv_bf16.cu`` (K1 on ``dense_wgmma.cuh``'s pipeline) and
``conv_bf16.cu`` (K3/K4's TMA pipeline of ``conv_ws.cuh``, with its own
entry points and the row layout of both conv pipelines,
``conv_layout.cuh``; the TMA pipelines reach the driver's
``cuTensorMapEncodeTiled`` through the runtime, so nothing links
libcuda), the fp32 FMA bodies on ``fma_gemm.cuh``'s register tile in
``feature_map_fma.cu`` (K2's kernel) and ``conv_fma.cu`` (K3/K4's
synchronous kernel, ``conv_sync.cuh``, with its entry points),
``conv_f64.cu``, and the float64 (DMMA) bodies of K1 and K2 in
``feature_map_f64.cu`` and ``ztzv_f64.cu``.  No --use_fast_math: it would turn
sincosf into the inaccurate __sincosf.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--split-compile=0"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    # name: argtypes (pointers and the stream are c_void_p; sigma and the
    # scales are doubles, rounded to float32 by the float32 bodies)
    "xgpr_feature_map": [_P] * 5 + [_I] * 4 + [_D, _I, _I, _I, _P],
    "xgpr_ztzv": [_P] * 5 + [_D] + [_P] * 7 + [_I] * 6
    + [_D, _I, _I, _I, _P],
    "xgpr_ztzv_reuse": [_P] * 5 + [_D] + [_P] * 9 + [_I] * 7
    + [_D, _I, _I, _P],
    "xgpr_conv_parts_tf32": [_P] * 9 + [_I] * 5 + [_D] + [_I] * 2 + [_P],
    "xgpr_conv_maxpool_tf32": [_P] * 7 + [_I] * 6 + [_P],
    "xgpr_conv_parts_sync": [_P] * 7 + [_I] * 6 + [_D, _I, _I, _P],
    "xgpr_conv_maxpool_sync": [_P] * 5 + [_I] * 7 + [_P],
    "xgpr_conv_parts_ws": [_P] * 8 + [_I] * 5 + [_D] + [_I] * 4 + [_P],
    "xgpr_conv_maxpool_ws": [_P] * 6 + [_I] * 8 + [_P],
    "xgpr_conv_tile_layout": [_P] * 2 + [_I] * 6 + [_P] * 6,
    "xgpr_ztzv_rhs_per_block": [_I] * 3,
}

_LIB = None
BUILD_SECONDS = None  # wall time of the build this process ran, if any
BUILD_LOG = ""        # compiler output of that build


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit (set CUDA_HOME).")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libxgpr_kernels_{digest.hexdigest()[:16]}.so"


def build(extra_flags=()) -> Path:
    """Compile the library unless a build of these exact sources exists.
    ``extra_flags`` go to every compile (e.g. ["-Xptxas", "-v"]); their
    output is kept in ``BUILD_LOG``."""
    global BUILD_SECONDS, BUILD_LOG
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    # Build in a private directory and rename the library into place, so
    # concurrent processes never load a half-written one.
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc] + NVCC_FLAGS + list(extra_flags) + \
                ["-c", str(src), "-o", str(obj)]
            procs.append((src.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for name, _, proc in procs:
            out = proc.communicate()[0]
            logs.append(f"--- {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        BUILD_LOG = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
        lib = Path(tmp) / "lib.so"
        link = subprocess.run([nvcc, "-shared", "-o", str(lib)] +
                              [str(obj) for _, obj, _ in procs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout +
                               link.stderr)
        os.replace(lib, target)
    BUILD_SECONDS = time.perf_counter() - t0
    return target


def library():
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(rc: int, what: str):
    """Raise when a C entry point reports a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
