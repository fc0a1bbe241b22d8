"""Device meshes, ported from ``repro/launch/mesh.py`` onto
``torch.distributed.device_mesh.init_device_mesh``.

Functions, not module-level constants: importing this module touches no
process group.  Each needs a default process group whose world size is
the mesh's size (``torch.distributed.init_process_group``; nothing on a
machine tells a program of its cluster, so the caller gives the address,
the world size and the rank).  ``device_type`` is ``"cuda"`` unless the
caller asks for ``"cpu"`` (a gloo group, as the tests run it).

The reference's production meshes are TPU v5e pods: 16x16 = 256 chips a
pod, and a leading "pod" axis of 2 for 512.  It lowers them on 512 fake
host devices in its dry run.  Here the dry run (``launch/dryrun.py``)
builds them with ``device_type="cpu"`` on a fake process group of 256 or
512 ranks in one process; on a smaller world ``make_production_mesh``
raises.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _mesh(shape: tuple, axes: tuple, device_type: str):
    size = 1
    for n in shape:
        size *= n
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != size:
        raise RuntimeError(f"a {shape} mesh needs a process group of {size} ranks; "
                           f"the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The 16x16 ("data", "model") mesh, or 2x16x16 ("pod", "data",
    "model") with ``multi_pod``.  Needs a process group of 256 / 512 ranks:
    a real one, or the dry run's fake one (``launch/dryrun.py::fake_group``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < size:
        raise RuntimeError(
            f"make_production_mesh: the {shape} mesh needs {size} ranks and the "
            f"world has {world}; the dry run builds it on a fake process group "
            "(python -m repro_torch.launch.dryrun)")
    return _mesh(shape, axes, device_type)


def make_test_mesh(n_data: int = 2, n_model: int = 2, pods: int = 0, *,
                   device_type: str = "cuda"):
    """A small ("data", "model") mesh, or ("pod", "data", "model") with
    ``pods``, for sharding tests (a world of n_data * n_model [* pods])."""
    if pods:
        return _mesh((pods, n_data, n_model), ("pod", "data", "model"), device_type)
    return _mesh((n_data, n_model), ("data", "model"), device_type)


def mesh_info(mesh) -> dict:
    return {
        "axis_names": list(mesh.mesh_dim_names),
        "shape": dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape))),
        "n_devices": int(mesh.size()),
        "device_type": mesh.device_type,
    }
