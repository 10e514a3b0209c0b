"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface (pointers, ints and the
stream as arguments; the cudaError_t of the launch as the result), so it
compiles with nvcc alone, in seconds, into a shared library that ctypes
loads. Nothing includes PyTorch's headers.

The build happens at first use, into `_build/` beside this package's
sources (listed in .gitignore). A library's file name carries a hash of
its source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited kernel is rebuilt and a stale one is never loaded. `build()`
starts one nvcc per source, all at once, and waits for them together.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("flash_fwd", "flash_bwd", "paged_decode", "embedding_gather",
           "row_update", "optimizer_update")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs = {}


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
            "the port's kernels are built from csrc/ at first use"
        )
    return path


def library_path(name):
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(
        BUILD_DIR, "lib%s-%s.so" % (name, digest.hexdigest()[:16])
    )


def build(names=SOURCES):
    """Compile every named source whose library is missing, one nvcc
    process each, all started together. Returns {name: {"seconds": s,
    "log": nvcc's stderr (ptxas register and shared-memory report)}};
    a library already built reports 0 seconds. Raises RuntimeError with
    nvcc's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    report = {}
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            report[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = "%s.%d.tmp" % (target, os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        out, err = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append("%s (rc %d):\n%s%s" % (
                name, proc.returncode, out, err))
            continue
        os.replace(tmp, target)
        report[name] = {"seconds": secs, "log": out + err}
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return report


def load(name):
    """The ctypes handle of kernel library `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib
