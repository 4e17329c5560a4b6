"""Build the package's CUDA kernels at first use and bind them with ctypes.

Every ``neurovit_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for sm_90a
(Hopper) and linked into one shared library with a plain C interface:
one ``nvt_*`` launch function per kernel, returning the launch's
``cudaError_t``. The library lands in ``build/neurovit_tpu_torch/`` at the
repository root under a name that hashes the sources, headers and flags, so
an edited source is rebuilt and an unchanged one is loaded as it is. Only
the sources in the checkout and the CUDA toolkit are used. The compiler's
output of a successful build (ptxas's registers, spills and warnings for
every kernel) is kept beside the library as ``<library>.log``
(:func:`build_log`, :func:`ptxas_report`).

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "neurovit_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v")
# Where the toolkit lives when neither CUDA_HOME nor PATH names it.
NVCC_FALLBACKS = ("/usr/local/cuda/bin/nvcc",)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install directory. Raises if there is none."""
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates += NVCC_FALLBACKS
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of neurovit_tpu_torch are compiled "
        "from neurovit_tpu_torch/csrc at first use and need the CUDA toolkit "
        "(set CUDA_HOME or put nvcc on PATH). CPU tensors run the plain "
        "PyTorch versions and need no build.")


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if the library for the current sources is not
    built yet; returns its path. Sources compile in parallel, one ``nvcc``
    each, and link with ``nvcc -shared``; the library is renamed into place
    only when complete, so a concurrent or interrupted build leaves no
    partial file under the final name."""
    nvcc = find_nvcc()
    lib = BUILD_DIR / f"libneurovit_kernels_{_digest(nvcc)}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = []
        procs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objects.append(str(obj))
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failures, outputs = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            outputs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failures.append(f"{src.name}:\n{out}")
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        partial = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *objects, "-o", str(partial)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log = Path(tmp) / build_log(lib).name
        log.write_text("".join(outputs))
        os.replace(log, build_log(lib))
        os.replace(partial, lib)
    return lib


def build_log(lib: Path) -> Path:
    """Where the compiler's output of the build of ``lib`` is kept."""
    return lib.with_suffix(".log")


def ptxas_report(text: str) -> tuple:
    """ptxas's ``-v`` output in a build log, per kernel: a list of
    ``(source, function, registers, spill store bytes, spill load bytes)``
    and the warnings and performance notes (each ``(source, function or
    "", line)``), such as C7514 and C7512 (wgmma serialised) or C7508
    (setmaxnreg ignored)."""
    kernels, warnings = [], []
    source, function, spills = "", "", (0, 0)
    for line in text.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            function, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and function:
            kernels.append((source, function, int(m.group(1)), *spills))
            continue
        if "warning" in line or re.search(r"\(C75\d\d\)", line):
            m = re.search(r"function '([^']+)'", line)
            warnings.append((source, m.group(1) if m else "", line.strip()))
    return kernels, warnings


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    return ctypes.CDLL(str(build()))


@functools.cache
def _function(name: str, argtypes: tuple):
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, argtypes: Sequence, *args) -> None:
    """Call the C launch function ``name`` and raise if the launch failed.
    Pointers and the stream go as ``ctypes.c_void_p``: ctypes would pass a
    bare Python int as a 32-bit C int and cut the pointer."""
    err = _function(name, tuple(argtypes))(*args)
    if err != 0:
        what = library().nvt_error_string
        what.restype = ctypes.c_char_p
        what.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{name} failed: CUDA error {err} ({what(err).decode()})")
