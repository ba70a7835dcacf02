"""Device mesh for GOP/tile sharding.

The port's counterpart of ``dct3d_tpu.parallel.mesh``.  The temporal GOP
axis and the spatial tile axis form a 2D grid of devices (axes "gop",
"tile"): GOPs are embarrassingly parallel (8-frame chunks with no
inter-block dependence, encoder.c:203-278), tiles split each frame's block
rows, and the only coupling between shards is the ordered concatenation of
their bits (sharding.py).

One process drives every device of a mesh (the JAX package's shard_map
does the same); the shards' work is queued on each device's current stream
in rank order, shard k = (g, t) with ``k = g * tile + t``.  A device may
appear more than once: its shards then run one after the other on its
stream.  That is how the CPU tests build their meshes (``[cpu] * 4``, the
counterpart of the JAX suite's virtual CPU devices) and how one card runs a
real (2, 3) mesh.  Several processes (multihost.py) add hosts on top.
"""

from __future__ import annotations

import torch

GOP_AXIS = "gop"
TILE_AXIS = "tile"


class Mesh:
    """A (gop, tile) grid of torch devices.

    ``shape`` is ``{"gop": g, "tile": t}`` as in a JAX mesh; ``devices``
    lists the shards' devices in rank order."""

    def __init__(self, devices: list[torch.device], gop: int, tile: int) -> None:
        if gop < 1 or tile < 1 or gop * tile != len(devices):
            raise ValueError(f"mesh {gop}x{tile} != {len(devices)} devices")
        self.devices = [torch.device(d) for d in devices]
        self.shape = {GOP_AXIS: gop, TILE_AXIS: tile}

    @property
    def distinct_devices(self) -> list[torch.device]:
        """Each device of the mesh once, in order of first appearance."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[GOP_AXIS]}x{self.shape[TILE_AXIS]}, "
                f"{[str(d) for d in self.devices]})")


def normalize_device(device) -> torch.device:
    """A CUDA device without an index names the current one; give it the
    index so that equal devices compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(gop: int | None = None, tile: int = 1,
              devices: list | None = None) -> Mesh:
    """Build a (gop, tile) mesh over ``devices`` (default: every CUDA
    device; raises RuntimeError when there is none — the CPU is used only
    when asked for).  ``gop`` defaults to all devices on the GOP axis.
    Raises ValueError when gop * tile differs from the device count."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device (torch.cuda.is_available() is "
                "false); pass devices=[torch.device('cpu')] * n for a CPU mesh"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [normalize_device(d) for d in devices]
    if gop is None:
        gop = len(devices) // tile
    return Mesh(devices, gop, tile)


def single_device_mesh(device=None) -> Mesh:
    """A 1x1 mesh on ``device`` (default: the first CUDA device)."""
    if device is None:
        return make_mesh(gop=1, tile=1, devices=make_mesh().devices[:1])
    return make_mesh(gop=1, tile=1, devices=[device])
