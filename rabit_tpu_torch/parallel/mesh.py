"""Process group and device: the port's stand-in for ``make_mesh``.

In JAX one program sees every device of the mesh; in PyTorch each process
holds its own shard and the ranks meet in a ``torch.distributed`` process
group. ``make_group`` sets up (or adopts) that group and resolves the
device this rank computes on: NCCL on the card, gloo on the CPU.
``make_mesh`` lays a mesh of named axes over that world ((dp, tp, sp) by
default, or one axis such as ``("pp",)``) and holds this rank's subgroup
of each; ``best_mesh_axis`` names its largest axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. Asking for CUDA where there is none
    raises: the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rabit_tpu_torch: CUDA was asked for but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "(or rabit_device=cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def refuse_tf32(what: str) -> None:
    """Raise if ``torch.backends.cuda.matmul.allow_tf32`` is on: ``what``
    holds its f32 products to f32, as the JAX package computes them."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{what} holds its f32 products to f32: set "
                           f"torch.backends.cuda.matmul.allow_tf32 = False")


def make_group(device: DeviceLike = None, rank: int = 0,
               world_size: int = 1, init_method: Optional[str] = None,
               ) -> Tuple[dist.ProcessGroup, torch.device]:
    """The default process group and this rank's device.

    An already initialised ``torch.distributed`` is adopted as it is.
    Otherwise the group is created: NCCL for a CUDA device (bound to it),
    gloo for the CPU. ``init_method`` (``tcp://host:port``) says where
    the ranks meet; without it, a world of one meets in an in-process
    store and a larger world reads the usual ``MASTER_ADDR``/
    ``MASTER_PORT`` environment."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.group.WORLD, dev
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend = "nccl"
        kwargs["device_id"] = dev
    else:
        backend = "gloo"
    store = None
    if init_method is None:
        if world_size == 1:
            store = dist.HashStore()
        else:
            init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world_size, **kwargs)
    return dist.group.WORLD, dev


AXES = ("dp", "tp", "sp")


@dataclass(frozen=True)
class Mesh:
    """A mesh over a ``torch.distributed`` world: its named axes, this
    rank's coordinates and the subgroup of each axis it belongs to. The
    counterpart of ``make_mesh(n, axes, shape)`` with
    ``jax.sharding.Mesh``'s rank layout, row-major over the axes: for
    (dp, tp, sp), rank = (d * tp + t) * sp + s.
    """

    shape: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Tuple[dist.ProcessGroup, ...]
    device: torch.device
    axes: Tuple[str, ...] = AXES

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[self.axes.index(axis)]

    def group(self, axis: str) -> dist.ProcessGroup:
        return self.groups[self.axes.index(axis)]


def make_mesh(shape: Tuple[int, ...] = (1, 1, 1),
              device: DeviceLike = None, rank: int = 0,
              init_method: Optional[str] = None,
              axes: Sequence[str] = AXES) -> Mesh:
    """The mesh of this rank over ``axes`` (by default (dp, tp, sp); one
    axis, e.g. ``("pp",)`` or ``("ep",)``, for the pipeline and the
    MoE). The world (the product of ``shape``) is set up or adopted as
    ``make_group`` does: NCCL on the card, gloo on the CPU. Every rank
    creates every subgroup, in the same order, including those it is not
    in (NCCL hangs otherwise); a world of one has trivial groups."""
    shape = tuple(int(n) for n in shape)
    axes = tuple(axes)
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"mesh shape must be {len(axes)} positive sizes "
                         f"{axes}, got {shape}")
    world = int(np.prod(shape))
    _, dev = make_group(device, rank, world, init_method)
    if dist.get_world_size() != world:
        raise ValueError(f"mesh {shape} needs a world of {world}, the "
                         f"process group has {dist.get_world_size()}")
    me = dist.get_rank()
    layout = np.arange(world).reshape(shape)
    coords = tuple(int(c) for c in np.argwhere(layout == me)[0])
    groups = []
    for axis in range(len(shape)):
        # the rank lists along this axis, the other coordinates fixed
        lines = np.moveaxis(layout, axis, -1).reshape(-1, shape[axis])
        mine = None
        for line in lines:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks)
            if me in ranks:
                mine = g
        groups.append(mine)
    return Mesh(shape, coords, tuple(groups), dev, axes)


def best_mesh_axis(mesh: Mesh) -> str:
    """The largest axis, where collectives get the most parallelism; a tie
    goes to the first in axis order (``rabit_tpu/parallel/mesh.py:43``)."""
    sizes = dict(zip(mesh.axes, mesh.shape))
    return max(sizes, key=sizes.get)
