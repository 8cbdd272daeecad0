"""Joining a multi-process run, the counterpart of
`cvaegan_tpu/parallel/distributed.py`.

JAX runs one process per host, each with its local devices; the port runs
one process per device (`torchrun --nproc-per-node N`, or processes
started with explicit arguments). Every process calls `initialize()`,
builds the same global mesh (`global_mesh`), and runs the same trainer
code under `mesh.use_mesh`: NCCL carries the collectives on CUDA, gloo on
the CPU.

    distributed.initialize()                 # under torchrun
    mesh = distributed.global_mesh()
    with use_mesh(mesh):
        CVAEGAN(seed=0).fit(ds)
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> None:
    """Join the process group: NCCL for `device="cuda"`, gloo for "cpu".

    With no `coordinator_address` it reads torchrun's environment
    (`env://`: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE), the counterpart
    of JAX's autodetection; else it meets the other processes at
    `tcp://{coordinator_address}` as process `process_id` of
    `num_processes`. On CUDA the process takes the device `LOCAL_RANK`
    (torchrun's; else `process_id` modulo the devices it sees)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on gloo")
    kwargs = {}
    if coordinator_address is None:
        kwargs["init_method"] = "env://"
        if num_processes is not None:
            kwargs["world_size"] = num_processes
        if process_id is not None:
            kwargs["rank"] = process_id
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id")
        kwargs.update(init_method=f"tcp://{coordinator_address}",
                      world_size=num_processes, rank=process_id)
    if device.type == "cuda":
        local = int(os.environ.get(
            "LOCAL_RANK", (process_id or 0) % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", **kwargs)


def is_multi_host() -> bool:
    """Whether the processes span more than one host (torchrun's
    LOCAL_WORLD_SIZE against the world; one host without torchrun)."""
    if not dist.is_initialized():
        return False
    world = dist.get_world_size()
    return world > int(os.environ.get("LOCAL_WORLD_SIZE", world))


def global_mesh(n_model: int = 1):
    """A ('data', 'model') mesh over every rank of the process group."""
    from cvaegan_tpu_torch.parallel.mesh import make_mesh

    n_total = dist.get_world_size()
    if n_total % max(n_model, 1):
        raise ValueError(
            f"model-parallel degree {n_model} does not divide the "
            f"{n_total} global devices")
    return make_mesh(n_total // n_model, n_model)
