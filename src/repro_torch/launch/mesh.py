"""Production mesh definitions (functions only -- importing this module
touches no process group).

Single pod : (16, 16)  = ("data", "model")          -> 256 ranks
Multi-pod  : (2, 16, 16) = ("pod", "data", "model") -> 512 ranks

The reference's shapes, kept as they are.  On the H100 a (16, 16) mesh is
256 cards, 32 hosts of 8.  NVLink joins only the 8 cards of a host, so the
16-way ``model`` axis spans two hosts and its collectives cross the
slower inter-host network; the ``data`` axis runs across hosts.  The
'pod' axis carries only data parallelism (plus ZeRO/compressed-grad
all-reduce), the slowest tier.

``make_production_mesh`` needs a process group of 256 (or 512) ranks: on
a cluster, one rank a card; in the dry-run, one process on the ``fake``
backend (``repro_torch.launch.dryrun``).
"""
from __future__ import annotations

__all__ = ["make_production_mesh", "make_mesh_shape"]


def make_mesh_shape(multi_pod: bool = False):
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the current process group, whose
    world size must be the mesh's 256 (or 512) ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = make_mesh_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
