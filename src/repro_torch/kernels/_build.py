"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, compiled by ``nvcc`` for ``sm_90a`` into ``build/repro_torch_kernels/``
at the repository root. The sources may include the headers
``csrc/*.cuh``: the tile GEMM of kernels A, D and E, ``tile_gemm.cuh``
(which sets its kernels' dynamic shared-memory limit itself), and the PTX
wrappers all five share, ``warp_ops.cuh``. The file name carries a hash of
the source, every header and the flags, so an edited kernel or header is
rebuilt and a stale library is never loaded. :func:`build` starts one
``nvcc`` per source, all at once, and waits for them together.

Pointers and the stream cross into C as ``ctypes.c_void_p``, integers as
``ctypes.c_int``. Every C entry point returns ``cudaGetLastError()`` after
its launch; :func:`check` raises on anything but 0. :func:`refuse_grad`
is every wrapper's first check: a kernel has no backward.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gemm", "flash_attention", "sparse24_gemm", "block24_gemm",
           "paged_attention")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures: (name, argument types). Every entry returns an int status.
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    # ... the operands and shapes, then the plan (kernels/gemm_plan.py):
    # tile, splits, steps per split, workspace, counters; then the stream
    "gemm": {"repro_gemm": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _P, _P, _P),
             # the same with the member count before the shapes
             "repro_gemm_batched": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _I, _P, _P, _P)},
    "flash_attention": {
        "repro_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _P)},
    "sparse24_gemm": {
        "repro_sparse24_gemm": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _P, _P, _P)},
    "block24_gemm": {
        "repro_block24_gemm": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _P, _P, _P)},
    "paged_attention": {
        # ... the operands, workspace and counters (null with one split),
        # shapes, then the split plan (kernels/paged_attention.py): splits,
        # positions per split; then the pools' type and the stream
        "repro_paged_flash_decode": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _I, _I, _I, _I, _I, _P)},
}

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's stderr per source (ptxas register / shared-memory report) and the
# wall seconds each build took; both filled by build().
LOGS: Dict[str, str] = {}
SECONDS: Dict[str, float] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    h = h.hexdigest()[:16]
    return build_dir() / f"lib{name}_{h}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library in ``names`` (default: all sources),
    one ``nvcc`` process each, started together. Raises with nvcc's
    stderr if any build fails."""
    names = tuple(names or SOURCES)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        stdout, stderr = proc.communicate()
        SECONDS[name] = time.perf_counter() - t0
        LOGS[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{stdout}{stderr}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _target(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def refuse_grad(what: str, *tensors) -> None:
    """Raise when autograd would have to differentiate through ``what``:
    grad mode on and an operand that requires grad. The kernels have no
    backward, and a tensor filled through ``ctypes`` has no ``grad_fn``,
    so the graph would be cut without a word. The reference's
    ``jax.grad`` through a ``pallas_call`` raises too; the registry's
    differentiable entries run a kernel inside an autograd ``Function``'s
    forward, where grad mode is off. Checked on every device, so the CPU
    twin refuses as the card does."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: autograd through a kernel entry point "
            "is refused (differentiate through the registry's entries, "
            "which run the kernel inside an autograd Function)")


# The dry-run's cost recorder (``launch/dryrun.py``), called as
# ``COST_SINK(kernel, operations, bytes)`` by :func:`meta_result`;
# set only while the dry-run traces a step.
COST_SINK = None


def costing(*tensors) -> bool:
    """Whether a kernel call is the dry-run's: its operands on ``meta``
    while the dry-run traces (:data:`COST_SINK` set). Outside a trace a
    ``meta`` operand is refused as any other non-CUDA tensor."""
    return COST_SINK is not None and all(t.is_meta for t in tensors)


def meta_result(kernel: str, shape, dtype, ops: float, nbytes: float,
                like: torch.Tensor) -> torch.Tensor:
    """A kernel's answer to ``meta`` operands while the dry-run traces
    (:func:`costing`, ``launch/dryrun.py``): nothing runs and nothing
    launches; the call is costed as the kernel (its operations and bytes,
    counted as ``chip_smoke.bound_ms`` counts them) and answered with an
    empty output of the kernel's shape and dtype. A card's tensors never
    reach here.
    The kernels take whole tensors, so a DTensor operand must live on a
    one-device mesh (a sharded product would need ``local_map`` with the
    matmul's placements)."""
    out = torch.empty(tuple(shape), dtype=dtype, device="meta")
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(like, DTensor):
        mesh = like.device_mesh
        if mesh.size() > 1:
            raise NotImplementedError(
                f"{kernel} on a mesh of {mesh.size()} devices: the port's "
                "kernels take whole tensors, so a kernel backend is costed "
                "on a one-device mesh only")
        out = DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    if COST_SINK is not None:
        COST_SINK(kernel, ops, nbytes)
    return out
