"""Process group and device: the port's stand-in for ``make_mesh``.

In JAX one program sees every device of the mesh; in PyTorch each process
holds its own shard and the ranks meet in a ``torch.distributed`` process
group. ``make_group`` sets up (or adopts) that group and resolves the
device this rank computes on: NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

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
