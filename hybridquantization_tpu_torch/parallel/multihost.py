"""Bringing up the ranks: one host or several.

The counterpart of `hybridquantization_tpu/parallel/multihost.py`. A JAX
process drives every device of its host; here each rank is one process with
one device. Three entry points:

  - `init_distributed` joins the process group of a job whose processes
    were started elsewhere (by hand, by a scheduler, across hosts): the
    counterpart of `jax.distributed.initialize`, and idempotent like it;
  - `distributed_mesh` lays a multi-host job out as JAX does (BASELINE
    config 5): the pixel axis stays inside a host, the data axis spans the
    hosts, so the neighbour exchanges of an image never leave its host;
  - `launch` starts the ranks of a job on this host, one process each
    (start method "spawn": a process that has touched CUDA must never fork),
    and returns what each rank's function returned. It is the counterpart
    of JAX's single-process mesh over the local devices.

The backend is explicit: NCCL (one card per rank) or gloo (the CPU, or
ranks that share a card; parallel.mesh copies CUDA operands through the
host for it). `default_backend` picks NCCL on "cuda" and gloo on "cpu"; a
job with more NCCL ranks on a host than cards is refused, never switched.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, rank_device

BACKENDS = ("nccl", "gloo")


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device, local_ranks: int) -> None:
    """Refuse what cannot run: an unknown backend, NCCL off the card, or
    more NCCL ranks on this host than cards."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {list(BACKENDS)}")
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError(f"nccl runs on cuda, not {device}")
        cards = torch.cuda.device_count()
        if local_ranks > cards:
            raise ValueError(
                f"nccl needs one card per rank: {local_ranks} ranks on this host, {cards} cards; "
                "ranks that share a card run with backend='gloo'"
            )


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device="cuda",
) -> None:
    """Join the job's process group (idempotent).

    coordinator_address: "host:port" (TCP, rank 0 listens) or a URL such as
    "file:///shared/path"; None reads MASTER_ADDR and MASTER_PORT.
    num_processes and process_id default to WORLD_SIZE and RANK. The
    ranks of this host are LOCAL_WORLD_SIZE (default: all of them), this
    rank's card LOCAL_RANK (default: its rank). backend: None picks
    `default_backend(device)`.
    """
    if dist.is_initialized():
        return
    backend = backend or default_backend(device)
    world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
    check_backend(backend, device, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device, rank))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


def distributed_mesh(pixel_per_host: int | None = None, device="cuda") -> Mesh:
    """(data, 1, pixel) mesh over every host's ranks: the pixel axis within
    a host, the data axis across hosts x the rest of each host's ranks.
    Ranks are host-major (rank = host * local + local rank)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    n_pixel = pixel_per_host or local
    if n_pixel > local:
        raise ValueError(f"mesh 1x1x{n_pixel} needs {n_pixel} ranks on a host, have {local}")
    if local % n_pixel:
        raise ValueError(f"{local} local ranks not divisible by pixel={n_pixel}")
    return make_mesh(world // n_pixel, n_pixel, 1, device)


def _rank_main(rank, world, fn, args, backend, device, init_method, out_dir):
    """One rank of `launch`: its environment, the group, fn, its result."""
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    torch.set_num_threads(1)
    init_distributed(init_method, world, rank, backend, device)
    out = fn(rank, *args)
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def launch(fn, nprocs: int, args: tuple = (), *, device="cuda", backend: str | None = None) -> list:
    """Run `fn(rank, *args)` in `nprocs` new processes on this host, each a
    rank of one process group, and return their results in rank order.

    fn must be a module-level function and return a picklable value (numpy
    arrays or CPU tensors). Each rank runs with one intra-op thread, card
    rank modulo the cards on "cuda", and the group's rendezvous in a file of
    a temporary directory. If a rank fails, the others are stopped and the
    failure is raised here. Build the CUDA kernels before launching
    (ops._cuda.library()), so the ranks do not each compile them.
    """
    backend = backend or default_backend(device)
    check_backend(backend, device, nprocs)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        mp.start_processes(
            _rank_main, args=(nprocs, fn, args, backend, str(device), init_method, tmp),
            nprocs=nprocs, join=True, start_method="spawn",
        )
        results = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
