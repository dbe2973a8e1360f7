"""Device meshes of the port: the counterpart of
``lazzaro_tpu/parallel/mesh.py:make_mesh`` and ``single_device_mesh``.

The JAX mesh is single-controller: one process drives every device through
``shard_map``. Here a :class:`Mesh` is a tuple of torch devices driven by one
process: ``MemoryIndex(mesh=...)`` keeps each shard's rows on its device,
launches each shard's scan there and merges the per-shard candidates on the
mesh's first device in place of the ``all_gather``. One axis, ``data`` (the
arena's rows), is ported; a device may appear more than once, so that
several shards share one card (or the CPU), as the JAX tests run 8 virtual
CPU devices. Multi-process meshes (NCCL, one process per card), more axes,
``make_hybrid_mesh`` and replica groups are ROADMAP Queue 1 item 21.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from lazzaro_tpu_torch.utils.device import resolve_device

_ITEM = "ROADMAP Queue 1 item 21, multi-device"


@dataclass(frozen=True)
class Mesh:
    """``devices[p]`` holds shard ``p`` of the mesh's one axis."""

    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, read as ``mesh.shape["data"]`` as in JAX."""
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(axis_names: Sequence[str] = ("data",),
              axis_sizes: Optional[Sequence[int]] = None,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """A one-axis mesh over ``devices``. ``None`` takes every CUDA device
    and raises ``RuntimeError`` without one; a CPU mesh exists only when
    the caller passes CPU devices (``devices=["cpu"] * 8``). A device may
    repeat: ``["cuda:0"] * 8`` is 8 shards on one card, the counterpart of
    the JAX tests' virtual devices."""
    axis_names = tuple(axis_names)
    if len(axis_names) != 1:
        raise NotImplementedError(
            f"a mesh with axes {axis_names}: only one axis is ported ({_ITEM})")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(): CUDA is not available; pass "
                               "devices=['cpu'] * n for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh(): no devices")
    if len({d.type for d in devs}) != 1:
        raise ValueError("make_mesh(): a mesh's devices must be of one type")
    if axis_sizes is not None and tuple(int(s) for s in axis_sizes) != (len(devs),):
        raise ValueError(f"mesh {tuple(axis_sizes)} needs {len(devs)} devices")
    return Mesh(axis_names, devs)


def single_device_mesh(device: Optional[Union[str, torch.device]] = None
                       ) -> Mesh:
    """A one-shard mesh on ``device`` (default: the current CUDA device)."""
    return make_mesh(("data",), (1,), devices=[resolve_device(device)])


def make_hybrid_mesh(*args, **kwargs):
    raise NotImplementedError(f"make_hybrid_mesh is not ported ({_ITEM})")


def replica_group_meshes(*args, **kwargs):
    raise NotImplementedError(f"replica_group_meshes is not ported ({_ITEM})")
