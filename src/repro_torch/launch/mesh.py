"""Device meshes (twin of ``repro.launch.mesh``) and the device assignment
of the disaggregated workers.

The mesh functions build a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of an initialised process group (``init_process_group``
here starts one). Single pod: (16, 16) = 256 ranks ("data", "model").
Multi-pod: (2, 16, 16) = 512 ranks ("pod", "data", "model").
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import torch


def shrink_shape(shape: Sequence[int], n: int) -> Tuple[int, ...]:
    """JAX's ``shrink=True`` rule: halve the largest axis (the first of
    equal ones) until the product fits ``n`` positions; an axis stops at
    1."""
    shape = list(shape)
    while _prod(shape) > n:
        i = max(range(len(shape)), key=lambda j: shape[j])
        if shape[i] == 1:
            break
        shape[i] = max(1, shape[i] // 2)
    return tuple(shape)


def compat_make_mesh(shape: Sequence[int], axes: Sequence[str], *,
                     shrink: bool = False, device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over ranks 0 .. prod(shape) - 1 in
    row-major order, named ``axes``. With ``shrink=True`` the shape is cut
    by ``shrink_shape`` to the world size first, as JAX cuts it to the
    device count. Needs an initialised process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("compat_make_mesh needs an initialised process "
                           "group (mesh.init_process_group)")
    if shrink:
        shape = shrink_shape(shape, dist.get_world_size())
    ranks = torch.arange(_prod(shape)).reshape(tuple(shape))
    return DeviceMesh(device, ranks, mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def mesh_context(mesh):
    """JAX's ambient-mesh context. PyTorch has no ambient mesh: the sharded
    step takes ``mesh`` (and ``rules``) as arguments, so this only yields
    the mesh, for code written as JAX's is."""
    yield mesh


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes, device=device)


def make_local_mesh(device: str = "cuda"):
    """Every rank of the process group, as a 1-D "data" mesh."""
    import torch.distributed as dist
    return compat_make_mesh((dist.get_world_size(),), ("data",),
                            device=device)


def init_process_group(rank: int, world: int, port: int,
                       device: str = "cuda", log=print) -> str:
    """Start the process group of ``world`` ranks at
    ``tcp://localhost:port`` and return its backend. On the CPU it is
    gloo. On the card it is NCCL when every rank has a card of its own
    (rank r takes card r), else gloo for both CPU and CUDA tensors
    (``"cpu:gloo,cuda:gloo"``: NCCL refuses two ranks on one card), with
    rank r on card r % cards. The choice is printed (``log``). A rank whose
    card cannot be reached raises."""
    import torch.distributed as dist
    if device == "cpu":
        backend = "gloo"
    else:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError(f"rank {rank}: no CUDA card")
        torch.cuda.set_device(rank % cards)
        torch.zeros(1, device="cuda")     # raises if the card is unreachable
        backend = "nccl" if cards >= world else "cpu:gloo,cuda:gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    if rank == 0 and log is not None:
        log(f"[mesh] {world} ranks on {device}"
            + ("" if device == "cpu" else
               f" ({torch.cuda.device_count()} card(s))")
            + f": backend {backend}")
    return backend


def _rank_main(rank, fn, world, port, device, args):
    import torch.distributed as dist
    init_process_group(rank, world, port, device)
    fn(rank, world, *args)
    # every rank past its last collective before any tears its sockets
    # down (a peer's gloo thread can abort the process on a closed pair)
    dist.barrier()
    dist.destroy_process_group()


def spawn(fn, world: int, args=(), device: str = "cuda"):
    """Run ``fn(rank, world, *args)`` in ``world`` new processes, each with
    the process group started (``init_process_group`` on a free port), and
    wait for them. Every rank's exit code is checked: a rank that fails
    raises here, naming the ranks and their codes (the others are then
    stopped). ``fn`` must be importable by name (a module-level
    function)."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main,
                             args=(fn, world, free_port(), device, args),
                             nprocs=world, join=False, start_method="spawn")
    err = None
    try:
        while not ctx.join():
            pass
    except Exception as e:                # the first rank that failed
        err = e
    codes = [p.exitcode for p in ctx.processes]
    if err is not None or any(c != 0 for c in codes):
        raise RuntimeError(f"ranks exited with codes {codes}") from err
    return codes


def free_port() -> int:
    """A free TCP port on this host, for ``init_process_group``."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def handoff_devices(n_prefill: int, n_decode: int
                    ) -> Tuple[List[Optional[torch.device]],
                               List[Optional[torch.device]]]:
    """Cards for the disaggregated roles (``engine/workers.py``): prefill
    workers take the first half of the host's cards and decode workers the
    rest, round-robin within each role, so the KV handoff is a real copy
    between cards (peer to peer) whenever the host has two or more. With
    fewer than two cards, or none, both lists are all None: the workers
    then share one device and the pages travel through host memory."""
    n = torch.cuda.device_count()
    if n < 2:
        return [None] * n_prefill, [None] * n_decode
    devs = [torch.device("cuda", i) for i in range(n)]
    split = max(1, min(n - 1, n // 2))
    pd, dd = devs[:split], devs[split:]
    return ([pd[i % len(pd)] for i in range(n_prefill)],
            [dd[i % len(dd)] for i in range(n_decode)])
