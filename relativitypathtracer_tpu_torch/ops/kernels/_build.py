"""Build, load and launch the port's CUDA kernels (csrc/*.cu).

Every source compiles in its own nvcc process, all started together, and
one more call links the objects into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so the build takes
seconds). The build runs at first use, inside the checkout under
build/kernels/, keyed by a hash of the sources and flags: a library built
from other sources is never loaded, it is rebuilt. ptxas reports each
kernel's registers, spills and shared memory; the report of the last build
is kept in BUILD_LOG.

Every launch goes through `launch`, which counts it in LAUNCHES (one plain
integer per kernel, or per route where one C entry stands for two TPU
kernels, so a run can show which kernels its path went through), runs on
the device that holds its tensors with that device's current stream, and
raises if the C entry reports a CUDA error.

Each C entry is also a PyTorch operator, `torch.ops.rpt.<name>` (`define_op`):
it allocates its outputs and returns them, its CUDA implementation launches
the kernel, its CPU implementation is the kernel's plain twin, and its fake
implementation gives the output shapes, so `torch.export` records the call as
one node (utils/aot). The Python wrappers of the kernel modules call these
operators; a wrapper routes a tensor that is on neither the CPU nor a CUDA
device to an error (`on_cpu`), never to the twin.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v")
HOST_SRC = CSRC / "octree_builder.cpp"
HOST_DIR = BUILD_DIR.parent / "host"
HOST_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-fPIC", "-shared")

# C entry -> argument kinds: p pointer, i int, f float. Every entry ends with
# the stream (a pointer) and returns the cudaError_t of its launch.
_SIGNATURES = {
    "rpt_shadow_chain": "pipppppfipppppp",
    "rpt_analytic_nearest": "piipipppppp",
    "rpt_shared_walk": "pppppppiipppppp",
    "rpt_general_walk": "pppppppiipp",
    "rpt_large_shared_walk": "ppppppppiiiiiipppppp",
    "rpt_large_general_walk": "ppppppppiiiiiipp",
    "rpt_batched_shared_walk": "pppppppppiiippppppp",
    "rpt_batched_general_walk": "ppppppppppiiipp",
    "rpt_footprint_sample": "pipipppppippp",
    "rpt_analytic_min_t": "piipppippp",
    "rpt_live_cull": "pipiippiiippppppp",
    "rpt_bucket_order": "ppiipppp",
    "rpt_cone_table": "piiipiiippiipiipiiippp",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

LAUNCHES: collections.Counter = collections.Counter()
BUILD_LOG = ""
HOST_LOG = ""
LIB = torch.library.Library("rpt", "DEF")  # the operators torch.ops.rpt.*

_lib = None


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run_all(cmds) -> list[str]:
    """Run the commands side by side; return their outputs, or raise with
    the output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return outs


def build() -> pathlib.Path:
    """Compile csrc/*.cu into build/kernels/librpt_kernels-<hash>.so unless
    that library already exists; return its path."""
    global BUILD_LOG
    so = BUILD_DIR / f"librpt_kernels-{source_hash()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    outs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                     for src, o in zip(sources, objs)])
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    BUILD_LOG = "\n".join(outs)
    os.replace(tmp, so)
    for old in BUILD_DIR.glob("librpt_kernels-*.so"):
        if old != so:
            old.unlink()
    return so


def build_host(flags=HOST_FLAGS) -> pathlib.Path:
    """Compile csrc/octree_builder.cpp with $CXX (else g++) and `flags` into
    HOST_DIR/librpt_octree-<hash of source and flags>.so unless that library
    already exists; return its path. Raises, naming the compiler and its
    output, when the compiler is missing or fails."""
    global HOST_LOG
    h = hashlib.sha256(" ".join(flags).encode() + HOST_SRC.read_bytes()).hexdigest()[:16]
    so = HOST_DIR / f"librpt_octree-{h}.so"
    if so.exists():
        return so
    HOST_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX") or "g++"
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *flags, "-o", str(tmp), str(HOST_SRC)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"host build: the compiler {cxx!r} cannot run ({e}): the octree "
                           "builder cannot be built") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host build: {cxx} failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    HOST_LOG = res.stdout + res.stderr
    os.replace(tmp, so)
    return so


def library():
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, kinds in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = [_CTYPES[k] for k in kinds]
            fn.restype = ctypes.c_int
        lib.rpt_error_string.argtypes = [ctypes.c_int]
        lib.rpt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_cuda(name: str, *specs, contiguous: bool = True) -> None:
    """specs: (tensor, dtype, shape) triples. Raise unless every tensor is a
    CUDA tensor of that dtype and shape, all on one device, and contiguous
    unless the kernel takes strides (`contiguous=False`)."""
    dev = specs[0][0].device
    for x, dtype, shape in specs:
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{name}: every input must be on one CUDA device, got {x.device}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
        if contiguous and not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def on_cpu(name: str, x) -> bool:
    """Route of a wrapper by the device of its tensor x: True on the CPU (the
    operator runs the plain twin), False on a CUDA device (it launches the
    kernel); any other device raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: every input must be on one CUDA device, got {x.device}")
    return False


def counter(like, count: bool):
    """The (1,) int32 zero a kernel adds its count into (a pre-test's tests
    run or skipped) on like's device, or an empty tensor when no count is
    asked for: an operator's counter result."""
    return torch.zeros(1 if count else 0, dtype=torch.int32, device=like.device)


def cached_constant(make):
    """Decorator for make(*key) -> a device tensor of host values (an index
    table, a mask): made once per hashable key, then shared, so that a
    frame after the first creates no tensor from host data (a CUDA graph's
    capture refuses the host-to-device copy). Callers only read it. The
    cache is never evicted: a captured graph reads the tensor by address. A
    program being traced (torch.export) gets the real tensor, made or found
    outside the trace, so that the artifact holds it as a constant."""
    cached = functools.lru_cache(maxsize=None)(make)

    @functools.wraps(make)
    def get(*key):
        if torch.compiler.is_compiling():
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

            with unset_fake_temporarily(), disable_proxy_modes_tracing():
                return cached(*key)
        return cached(*key)

    return get


@cached_constant
def _constant(values: tuple, dtype: torch.dtype, device: torch.device):
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype: torch.dtype, device):
    """The 1-D tensor of `values` (a sequence of Python numbers) on `device`,
    made once per (values, dtype, device) (`cached_constant`)."""
    return _constant(tuple(values), dtype, torch.device(device))


def define_op(name: str, schema: str, cuda, cpu, fake):
    """Register the operator torch.ops.rpt.<name> with `schema` (its
    arguments and results): `cuda` launches the kernel, `cpu` is the plain
    twin, `fake` gives the results' shapes and dtypes from the arguments'.
    Every result is a new tensor; no argument is written. Returns the
    operator."""
    LIB.define(name + schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"rpt::{name}", fake, lib=LIB)
    return getattr(torch.ops.rpt, name)


def launch(name: str, *args, key: str | None = None) -> None:
    """Call C entry `name` with tensors as device pointers (None as a null
    pointer), then the current stream of the device that holds the tensors,
    with that device current; count the launch under `key` (default `name`);
    raise if the tensors lie on more than one device, or on a CUDA error."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dev = tensors[0].device
    if any(a.device != dev for a in tensors):
        raise ValueError(f"{name}: tensors on more than one device: "
                         f"{sorted({str(a.device) for a in tensors})}")
    lib = library()
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        LAUNCHES[key or name] += 1
        rc = getattr(lib, name)(*c_args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: {lib.rpt_error_string(rc).decode()}")
