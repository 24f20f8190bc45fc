"""Build and bind the routing kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

Nothing is compiled when this module is imported.  The first call of
``library()`` compiles ``csrc/routing.cu`` for ``sm_90a`` into
``kernels/_build/`` (git ignores it), under a name keyed on the sources and
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is.  ``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin`` and
``/usr/local/cuda/bin``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("routing.cu", "routing.cuh")

#: never --use_fast_math: the jump step needs IEEE round-to-nearest division
CODEGEN_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
NVCC_FLAGS = (*CODEGEN_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_N = ctypes.c_longlong
#: C signatures of the entry points (every pointer and the stream as void*)
SIGNATURES = {
    "routing_route": (_I, _P, _P, _I, _P, _I, _P, _I, _P, _N, _P),
    "routing_ingest": (_I, _P, _P, _P, _I, _P, _I, _P, _I, _P, _N, _P),
    "routing_lookup_dyn": (_I, _P, _P, _I, _P, _N, _P),
    "routing_lookup_vec": (_I, _P, _U, _U, _U, _I, _P, _N, _P),
}


def nvcc() -> str:
    """Path of the CUDA compiler; raises if the toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "routing kernels are compiled from source at first use"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path, flags: tuple[str, ...]) -> Path:
    """Run nvcc on routing.cu into ``out`` unless it exists.  Concurrent
    builds each write a temporary file and rename it into place, so a
    reader never sees a partial output; the compiler's report goes to a
    ``.log`` beside it."""
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=out.suffix)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *flags, "-o", tmp, str(CSRC / "routing.cu")],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build() -> Path:
    """Compile the kernel library unless this exact build exists; returns
    its path."""
    return _compile(BUILD_DIR / f"librouting_{_digest()}.so", NVCC_FLAGS)


def ptx() -> Path:
    """The same sources compiled to PTX, for checking which instructions
    the compiler chose (e.g. ``div.rn.f32`` for the jump step)."""
    return _compile(BUILD_DIR / f"routing_{_digest()}.ptx", (*CODEGEN_FLAGS, "-ptx"))


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's signature set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
