"""Build and load the port's CUDA kernels and its host C++ libraries.

Each `csrc/<name>.cu` has a plain C interface (pointers, ints and the
stream as arguments; the cudaError_t of the launch as the result), so it
compiles with nvcc alone, in seconds, into a shared library that ctypes
loads. Nothing includes PyTorch's headers.

The build happens at first use, into `_build/` beside this package's
sources (listed in .gitignore). A library's file name carries a hash of
its source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited kernel is rebuilt and a stale one is never loaded. `build()`
starts one nvcc per source, all at once, and waits for them together. A
source named in PARTS is compiled as several objects, one nvcc each with
`-DEDL_PART=<i>` (each holding a share of its kernel instances), all
started with the rest, and linked into its one library.

A source named in HOST_SOURCES (`csrc/<name>.cc`: the host-DRAM
embedding store) is host C++, built the same way with the host compiler
(`c++ -O3 -shared -fPIC`, $CXX overrides the compiler) under the same
kind of hashed name. It needs no CUDA toolkit, so it builds on a machine
without one too.

Every build writes a file of its own (the process id in its name) and
renames it into place, so processes that build one library at once
never load a half-written file.
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
HOST_SOURCES = ("host_embedding",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# source -> number of parts (part 0 the entry points and fp32 kernels,
# the others the bf16 tensor-core instances: csrc/flash_bwd.cu one
# (pass, head dim, output dtype) each, csrc/flash_fwd.cu one (head dim,
# causal) each; csrc/paged_decode.cu one arena dtype each)
PARTS = {"flash_bwd": 9, "flash_fwd": 5, "paged_decode": 3}
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

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


def cxx_path():
    found = shutil.which(os.environ.get("CXX") or "c++")
    if not found:
        raise RuntimeError(
            "no host C++ compiler ($CXX or c++ on PATH); the port's host "
            "libraries are built from csrc/ at first use")
    return found


def library_path(name):
    digest = hashlib.sha256()
    if name in HOST_SOURCES:
        sources, flags = [name + ".cc"], CXX_FLAGS
    else:
        headers = sorted(f for f in os.listdir(CSRC_DIR)
                         if f.endswith(".cuh"))
        sources, flags = [name + ".cu"] + headers, NVCC_FLAGS
    for fname in sources:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(flags).encode())
    digest.update(b"parts %d" % PARTS.get(name, 0))
    return os.path.join(
        BUILD_DIR, "lib%s-%s.so" % (name, digest.hexdigest()[:16])
    )


def build(names=SOURCES + HOST_SOURCES):
    """Compile every named source whose library is missing, one compiler
    process per source (per part for a source in PARTS), all started
    together: nvcc for a CUDA source, the host compiler for one of
    HOST_SOURCES. Returns {name: {"seconds": s, "log": the compiler's
    output (for nvcc, ptxas's register, spill and shared-memory
    report)}}; a library already built reports 0 seconds. Raises
    RuntimeError with the compiler's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}  # name -> [(process, output file)]
    report = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            report[name] = {"seconds": 0.0, "log": ""}
            continue
        stem = "%s.%d" % (target, os.getpid())
        if name in HOST_SOURCES:
            src = os.path.join(CSRC_DIR, name + ".cc")
            cmds = [([cxx_path(), *CXX_FLAGS, "-o", stem + ".tmp", src],
                     stem + ".tmp")]
        elif name in PARTS:
            src = os.path.join(CSRC_DIR, name + ".cu")
            nvcc = nvcc_path()
            cmds = [([nvcc, *NVCC_FLAGS, "-c", "-DEDL_PART=%d" % i, "-o",
                      "%s.part%d.o" % (stem, i), src],
                     "%s.part%d.o" % (stem, i))
                    for i in range(PARTS[name])]
        else:
            src = os.path.join(CSRC_DIR, name + ".cu")
            cmds = [([nvcc_path(), *NVCC_FLAGS, "-shared", "-o",
                      stem + ".tmp", src], stem + ".tmp")]
        jobs[name] = [(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            out) for cmd, out in cmds]
    failures = []
    for name, procs in jobs.items():
        logs, outs, ok = [], [], True
        for proc, out in procs:
            stdout, stderr = proc.communicate()
            logs.append(stdout + stderr)
            outs.append(out)
            if proc.returncode != 0:
                ok = False
                failures.append("%s (rc %d):\n%s%s" % (
                    name, proc.returncode, stdout, stderr))
        if not ok:
            continue
        target = library_path(name)
        if name in PARTS:
            nvcc = nvcc_path()
            lib_tmp = outs[0].rsplit(".part", 1)[0] + ".tmp"
            link = subprocess.run([nvcc, "-shared", "-o", lib_tmp, *outs],
                                  capture_output=True, text=True)
            for out in outs:
                os.remove(out)
            if link.returncode != 0:
                failures.append("%s link (rc %d):\n%s%s" % (
                    name, link.returncode, link.stdout, link.stderr))
                continue
            outs = [lib_tmp]
        os.replace(outs[0], target)
        report[name] = {"seconds": time.perf_counter() - t0,
                        "log": "".join(logs)}
    if failures:
        raise RuntimeError("the build failed for " + "\n".join(failures))
    return report


def load(name):
    """The ctypes handle of library `name` (a kernel's, or one of
    HOST_SOURCES), built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib
