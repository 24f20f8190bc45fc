"""Build and bind the kernels: ``nvcc`` into shared libraries with a plain C
interface, loaded with ``ctypes``.  Two libraries: the routing kernels
(``csrc/routing.cu``, ``library()``) and the training kernels
(``csrc/train.cu``: the fused AdamW update and the radix select's two
kernels, ``train_library()``), each keyed on its own sources and flags.

Nothing is compiled when this module is imported.  The first call of
``library()`` compiles ``csrc/routing.cu`` for ``sm_90a`` into
``kernels/_build/`` (git ignores it), under a name keyed on the sources and
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is.  ``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME/bin`` and
``/usr/local/cuda/bin``.

Beside the library, the same sources give three more outputs, each built
at its first use: ``ptx()`` and ``cubin()`` (the code the library holds, as
PTX and as a line-info cubin, for the SASS gate), and ``counting()``, the
counting build: the library compiled with ``ROUTING_COUNT_TRIPS`` defined,
so that every counted loop of ``routing.cuh`` keeps its largest trip
count in a device array (``counting_library()`` loads it).  The training
library is built the same way, at its own first use, into the same
directory (``libtrain_<hash>.so``).
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
#: the training kernels' library: its own sources, the same flags
TRAIN_SOURCES = ("train.cu",)

#: never --use_fast_math: the jump step needs IEEE round-to-nearest division
CODEGEN_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
NVCC_FLAGS = (*CODEGEN_FLAGS, "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the counting build's one added flag (routing.cuh: CT_TRIPS and its kin)
COUNT_FLAGS = (*NVCC_FLAGS, "-DROUTING_COUNT_TRIPS")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_N = ctypes.c_longlong
_F = ctypes.c_float
#: C signatures of the entry points (every pointer and the stream as void*)
SIGNATURES = {
    "routing_route": (_I, _P, _P, _I, _P, _I, _P, _I, _P, _N, _P),
    "routing_ingest": (_I, _P, _P, _P, _I, _P, _I, _P, _I, _P, _N, _P),
    "routing_lookup_dyn": (_I, _P, _P, _I, _P, _N, _P),
    "routing_lookup_vec": (_I, _P, _U, _U, _U, _I, _P, _N, _P),
    "routing_lookup_router": (_I, _P, _I, _U, _U, _U, _U, _U, _I, _P, _N, _P),
    "routing_route_load": (_I, _P, _P, _I, _P, _I, _P, _I, _P, _N, _P, _I, _I, _P),
    "routing_route_family": (_I, _P, _U, _P, _I, _P, _I, _P, _I, _P, _N, _P),
    "routing_resolve": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _N, _P),
    "routing_place": (_I, _P, _I, _P, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P, _N, _P),
    "routing_node_route": (_I, _P, _P, _I, _P, _I, _P, _I, _P, _U, _I, _P, _P, _P, _N, _P),
    "routing_chain_remap": (_P, _P, _P, _I, _P, _I, _P, _N, _P),
    "routing_chain_grid": (_N,),
    "routing_route_load_grid": (_I, _N, _I),
    "routing_resolve_rows_shape": (_I, _I, _N, _P),
    "routing_take_launches": (_P, _I),
}
#: C signatures of the training library's entry points
TRAIN_SIGNATURES = {
    "train_adamw_update": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _F, _F, _F, _F, _F, _N, _P),
    "train_radix_hist": (_P, _N, _I, _I, _P, _P, _P),
    "train_radix_pick": (_P, _I, _I, _P, _P, _P),
}
#: the entry points only the counting build has
TRIP_SIGNATURES = {
    "routing_trips_reset": (_P,),
    "routing_trips_read": (_P, _P),
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


def _digest(flags: tuple[str, ...] = NVCC_FLAGS, sources: tuple[str, ...] = SOURCES) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sources:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path, flags: tuple[str, ...], source: str = SOURCES[0]) -> Path:
    """Run nvcc on ``source`` (routing.cu unless named) into ``out`` unless
    it exists.  Concurrent builds each write a temporary file and rename it
    into place, so a reader never sees a partial output; the compiler's
    report goes to a ``.log`` beside it."""
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=out.suffix)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *flags, "-o", tmp, str(CSRC / source)],
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


def build_train() -> Path:
    """Compile the training kernels' library unless this exact build
    exists; returns its path."""
    digest = _digest(NVCC_FLAGS, TRAIN_SOURCES)
    return _compile(BUILD_DIR / f"libtrain_{digest}.so", NVCC_FLAGS, TRAIN_SOURCES[0])


def ptx() -> Path:
    """The same sources compiled to PTX, for checking which instructions
    the compiler chose (e.g. ``div.rn.f32`` for the jump step)."""
    return _compile(BUILD_DIR / f"routing_{_digest()}.ptx", (*CODEGEN_FLAGS, "-ptx"))


def cubin() -> Path:
    """The same sources and code generation flags compiled to a cubin with
    line info (``-lineinfo``, which leaves the code as it is), so that a
    disassembly maps each instruction to its source line."""
    return _compile(BUILD_DIR / f"routing_{_digest()}.cubin",
                    (*CODEGEN_FLAGS, "-cubin", "-lineinfo"))


def counting() -> Path:
    """The counting build: the library's sources and flags with
    ``ROUTING_COUNT_TRIPS`` defined, under a name of its own; its outputs
    are the library's, and each counted loop's trips are kept besides."""
    return _compile(BUILD_DIR / f"librouting_trips_{_digest(COUNT_FLAGS)}.so", COUNT_FLAGS)


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program beside ``nvcc`` (``cuobjdump``,
    ``nvdisasm``); raises naming it if it is absent."""
    found = shutil.which(name)
    if found:
        return found
    beside = Path(nvcc()).parent / name
    if beside.is_file():
        return str(beside)
    raise RuntimeError(f"{name} not found (PATH, beside nvcc at {beside.parent})")


def _load(path: Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's signature set."""
    return _load(build(), SIGNATURES)


@functools.cache
def train_library() -> ctypes.CDLL:
    """The loaded training kernels' library with every entry point's
    signature set."""
    return _load(build_train(), TRAIN_SIGNATURES)


@functools.cache
def counting_library() -> ctypes.CDLL:
    """The loaded counting build: the library's entry points and the two
    that reset and read the trip counts."""
    return _load(counting(), {**SIGNATURES, **TRIP_SIGNATURES})
