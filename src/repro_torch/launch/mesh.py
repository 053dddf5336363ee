"""Production device meshes over a fake process group.

Twin of ``repro/launch/mesh.py``. The reference builds its meshes over 512
placeholder host devices; the port builds ``DeviceMesh``es over the ranks
of one ``fake`` process group (``torch.testing._internal.distributed.
fake_pg``, shipped in the torch wheel, as torch's own DTensor tests use
it): this process is rank 0 of a world of :data:`WORLD` ranks, and a
collective completes at once without moving a byte. A mesh of n devices
takes ranks 0..n-1, so this process is in every mesh. Nothing here runs on
import: the process group is made by the first mesh and lives until
:func:`destroy`.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

# The largest mesh asked for: the multi-pod (pod=2, data=16, model=16).
WORLD = 512


def _world(n: int) -> None:
    """The fake process group of :data:`WORLD` ranks, made once."""
    import torch.distributed as dist
    if n > WORLD:
        raise ValueError(f"a mesh of {n} devices exceeds the world of "
                         f"{WORLD}")
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=WORLD)
    elif dist.get_backend() != "fake" or dist.get_world_size() < n:
        raise RuntimeError(
            f"a {dist.get_backend()} process group of "
            f"{dist.get_world_size()} ranks is up: the meshes need the fake "
            f"group of {WORLD}")


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` with dim names ``axes`` over ranks
    0..prod(shape)-1 (for tests and sub-mesh experiments)."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(shape), tuple(axes)
    n = math.prod(shape)
    _world(n)
    # "cuda" names the collectives' flavour, NCCL's (on "cpu" DTensor
    # swaps an all-to-all for an all-gather, gloo having none); the
    # dry-run's tensors stay on ``meta`` and no CUDA call is made
    return DeviceMesh("cuda", torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (data=16, model=16), 256 devices. Multi-pod: (pod=2,
    data=16, model=16), 512 devices."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def destroy() -> None:
    """Tear the fake process group down (tests, and after a dry run inside
    a process that goes on to other work)."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()
