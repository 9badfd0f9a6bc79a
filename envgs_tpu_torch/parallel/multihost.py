"""Multi-process orchestration helpers (port of
envgs_tpu/parallel/multihost.py on torch.distributed).

The reference's rank helpers and its rank-0 service policy: the
evaluator, the recorder and the checkpoints run on rank 0 only. Without an
initialized default group the process is rank 0 of 1, as a JAX program on
one host is. Under torchrun (`torchrun --nproc_per_node N -m
envgs_tpu_torch ...`) `init_from_env` starts the default group from
torchrun's RANK / WORLD_SIZE / LOCAL_RANK and puts each rank on its card.
"""
from __future__ import annotations

import datetime
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if _initialized() else 0


def process_count() -> int:
    """Number of participating processes (1 without a group)."""
    return dist.get_world_size() if _initialized() else 1


def is_main_process() -> bool:
    """Rank-0 gate of the evaluation, recording and saving services."""
    return process_index() == 0


def barrier():
    """Block until every rank reaches this point (no-op on one)."""
    if process_count() > 1:
        dist.barrier()


def shard_for_host(items: Sequence, rank: int | None = None,
                   world: int | None = None) -> list:
    """The reference's frame sharding `ims[:, rank::world_size]` for any
    item list."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    return list(items)[rank::world]


def allsum_hosts(vec) -> np.ndarray:
    """Elementwise sum of a small vector over the ranks, in float64 (on
    the rank's card under NCCL, which reduces CUDA tensors only). One
    rank: the vector itself, as float64."""
    if process_count() == 1:
        return np.asarray(vec, np.float64)
    dev = "cpu"
    if dist.get_backend() == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor(np.asarray(vec, np.float64), dtype=torch.float64,
                     device=dev)
    dist.all_reduce(t)
    return t.cpu().numpy()


def init_from_env(backend: str, device=None,
                  timeout: datetime.timedelta | None = None) -> torch.device:
    """Start the default group from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) with `backend`
    ("nccl": a card a rank; "gloo") unless one is running, and return this
    rank's device: `device` when given, else cuda:LOCAL_RANK (made the
    current card)."""
    if not _initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(
            backend, init_method="env://", rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]), **kw)
    dev = torch.device(device if device is not None
                       else f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    return dev
