"""Multi-process training: the process group, each rank's device and rows.

Counterpart of sd_lora_trainer_tpu/parallel/distributed.py. One process runs
one device. A launcher starts the processes:

    torchrun --nproc_per_node 8 -m sd_lora_trainer_tpu_torch.main cfg.json

torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) forms the group; so does the JAX package's SDT_COORDINATOR
("host:port"), SDT_NUM_PROCESSES and SDT_PROCESS_ID, so one launch script
serves both packages. The backend is NCCL for a CUDA device and gloo for the
CPU; SDT_DIST_BACKEND names another (gloo, for ranks that share one card,
which NCCL refuses). The run prints the backend it formed; none is swapped
on its own.

As in JAX, every rank runs the same deterministic host pipeline and builds
the identical global batch; `local_rows` keeps its data group's rows.
`config.train_batch_size` stays global. Rank 0 writes the artifacts; the
sharded trainables are gathered into its host memory first, a collective
every rank enters.
"""

from __future__ import annotations

import datetime
import os
from typing import Tuple

import torch
import torch.distributed as dist

from sd_lora_trainer_tpu_torch.parallel.sharding import _map

# the collectives' timeout: covers the validation renders rank 0 runs while
# the other ranks wait at a barrier (about 2 s an SDXL image on an H100)
TIMEOUT = datetime.timedelta(minutes=60)


def _cluster() -> Tuple[int, int, str]:
    """(world, rank, init_method) the environment asks for; no init_method
    if it names no launcher."""
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        return int(os.environ["WORLD_SIZE"]), int(os.environ.get("RANK", "0")), "env://"
    coord, nproc = os.environ.get("SDT_COORDINATOR"), os.environ.get("SDT_NUM_PROCESSES")
    if coord and nproc:
        return int(nproc), int(os.environ.get("SDT_PROCESS_ID", "0")), f"tcp://{coord}"
    return int(os.environ.get("WORLD_SIZE", "1")), int(os.environ.get("RANK", "0")), ""


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("SDT_PROCESS_ID", "0")))


def rank_device(device: str) -> torch.device:
    """This process's device: cuda:{LOCAL_RANK % device_count} for "cuda"."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return dev


def maybe_initialize_distributed(device: str = "cuda") -> Tuple[int, int]:
    """Form the process group when a launcher's environment asks for one
    (of any size, one process included, as JAX's SDT_* cluster); returns
    (world, rank). A second call is a no-op. A requested cluster that does
    not form raises."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    world, rank, init_method = _cluster()
    if not init_method:
        if world > 1:
            raise RuntimeError(f"WORLD_SIZE={world} but no MASTER_ADDR/MASTER_PORT nor "
                               "SDT_COORDINATOR: launch with torchrun, or set the SDT_* variables")
        return 1, 0
    dev = rank_device(device)
    backend = os.environ.get("SDT_DIST_BACKEND") or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=TIMEOUT)
    if dist.get_world_size() != world:
        raise RuntimeError(f"requested a {world}-process group, formed {dist.get_world_size()}")
    print(f"[distributed] process {rank}/{world}, backend {dist.get_backend()}, device {dev}",
          flush=True)
    return world, rank


def local_rows(tree, n_data: int, data_rank: int, axis: int = 1):
    """This data rank's rows of every batch leaf (numpy or torch) with more
    than `axis` dims ([accum, B, ...] by default); 0-d leaves pass."""

    def rows(x):
        if getattr(x, "ndim", 0) <= axis:
            return x
        k = x.shape[axis] // n_data
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(data_rank * k, (data_rank + 1) * k)
        return x[tuple(idx)]

    return {k: rows(v) for k, v in tree.items()}


def unshard_to_rank0(tree, plan):
    """The trainable tree with every fsdp shard gathered whole into rank
    0's host memory (rank 0 writes the files) and None in its place on the
    other ranks; replicated leaves pass as they are. Under fsdp a
    collective every rank enters, one tensor at a time, so no card holds
    more than one whole tensor beyond its shards."""
    if plan is None or plan.fsdp is None:
        return tree
    return _map(tree, lambda _, t: plan.fsdp.on_rank0(plan.fsdp.full_of(t))
                if plan.is_sharded(t) else t)


def barrier() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
