"""Data-parallel groups of ranks (counterpart of ``msd_tpu/parallel/mesh_utils.py``).

``msd_tpu`` shards a batch over a 1-D device mesh and lets XLA insert the
gradient psum. The port runs one process per rank instead: a
``torch.distributed`` process group, each rank on its own device (NCCL, one
GPU per rank) or several ranks on one device or on the CPU (gloo). The
only collective is ``all_reduce``, which gloo carries for CUDA tensors
too, so either backend works.

``run_ranks`` starts ``world_size`` processes (spawn), gives each a
``DataParallelGroup`` and returns what each rank's function returned. The
rendezvous is a file (``file://``), so no port is opened; a rank that
hangs or fails ends every rank and raises in the caller. Each rank runs
on the card unless its device is given as the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time

import torch


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass
class DataParallelGroup:
    """A rank's view of its group: the ``torch.distributed`` process group
    (None for a single rank), its rank, the world size and its device."""

    process_group: object
    rank: int
    world_size: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def scene_slice(self, n: int) -> slice:
        """This rank's share of ``n`` scenes (``n`` a multiple of the world size)."""
        if n % self.world_size:
            raise ValueError(f"{n} scenes do not split over {self.world_size} ranks")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce_(self, tensors) -> None:
        """Sum ``tensors`` over the ranks in place, in one collective (they
        are packed into one float32 buffer)."""
        tensors = [t for t in tensors if t is not None]
        if self.world_size == 1 or not tensors:
            return
        import torch.distributed as dist

        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.process_group)
        offset = 0
        for t in tensors:
            n = t.numel()
            t.detach().copy_(flat[offset:offset + n].view(t.shape))
            offset += n


def init_group(init_method: str, world_size: int, rank: int, backend: str = "gloo",
               device=None) -> DataParallelGroup:
    """Join the default process group and return this rank's view of it.
    ``device`` defaults to the card ``cuda:<rank % cards>`` under either
    backend (gloo on one card: every rank on ``cuda:0``) and raises where
    there is no card; pass ``device="cpu"`` to run the rank on the CPU."""
    import torch.distributed as dist

    if backend == "gloo":
        # loopback only: the ranks run on one host
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_group: no CUDA device; pass device='cpu' to run the rank on the CPU")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return DataParallelGroup(dist.group.WORLD, rank, world_size, device)


def _rank_main(rank, fn, world_size, init_method, backend, devices, out_dir, args):
    import torch.distributed as dist

    group = init_group(init_method, world_size, rank, backend, devices[rank] if devices else None)
    try:
        torch.save(fn(group, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, args=(), backend: str = "gloo", devices=None, timeout: float = 600.0,
              workdir: str | None = None):
    """Run ``fn(group, *args)`` on ``world_size`` spawned ranks; returns
    the list of their return values (saved with ``torch.save``, so keep
    them on the CPU). ``fn`` must be importable by the spawned processes
    (a module-level function). ``devices``: one device per rank (default
    as ``init_group``: the card). Raises, naming every rank that raised,
    if a rank fails, or if the ranks outlast ``timeout`` seconds; every
    rank has ended when this returns."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ranks_", dir=workdir) as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(_rank_main, (fn, world_size, init_method, backend, devices, tmp, args),
                                 nprocs=world_size, join=False)
        deadline = time.monotonic() + timeout
        try:
            # join returns as ranks end; on a failure it gives the others 5 s
            # to end (a peer may wait in a collective that will not complete),
            # ends them and raises
            while not ctx.join(max(0.0, deadline - time.monotonic()), grace_period=5.0):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"ranks still running after {timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raised = []
            for r, path in enumerate(ctx.error_files):
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        raised.append(f"rank {r}: {pickle.load(f).strip().splitlines()[-1]}")
            raise RuntimeError("; ".join(raised) or str(e)) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world_size)]
