"""Data-parallel groups of ranks (counterpart of ``msd_tpu/parallel/mesh_utils.py``).

``msd_tpu`` shards a batch over a 1-D device mesh and lets XLA insert the
gradient psum. The port runs one process per rank instead: a
``torch.distributed`` process group, each rank on its own device (NCCL, one
GPU per rank) or several ranks on one device or on the CPU (gloo).
Training sums gradients with ``all_reduce_``, which gloo carries for CUDA
tensors too; serving gathers each rank's rows with ``all_gather_rows``
(``shard_map``'s ``out_specs=P("data")``), staged through host memory
under gloo and gathered on the card under NCCL.

Points-mode Stage 2 differentiates through both collectives, as XLA does
inside ``msd_tpu``'s jitted SPMD step: every rank computes the same loss
from the gathered rows, so ``all_gather_rows``'s backward hands each rank
its own rows of the incoming gradient, and ``all_reduce_sum``'s backward
sums the ranks' incoming gradients (each rank's graph holds only its own
rows' share of the loss's dependence on the sum). Both keep their input's
dtype.

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
        return self.row_slice(n)

    def row_slice(self, n: int) -> slice:
        """This rank's contiguous share of ``n`` rows as ``P("data")``
        shards them: ``ceil(n / world_size)`` rows each, the last ranks
        short or empty (the padding rows ``msd_tpu`` adds for SPMD are left
        out)."""
        per = -(-n // self.world_size)
        return slice(min(self.rank * per, n), min((self.rank + 1) * per, n))

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

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (rows of any count, the same trailing shape
        and dtype on every rank) stacked in rank order, on every rank, on
        ``t``'s device. Rows are padded to the longest rank's count for the
        collective and trimmed after it. Differentiable: the gradient of
        ``t`` is this rank's rows of the result's gradient."""
        if self.world_size == 1:
            return t
        return _AllGatherRows.apply(t, self)

    def _gather_rows(self, t: torch.Tensor):
        """(the gathered rows, every rank's row count)."""
        import torch.distributed as dist

        # gloo gathers host tensors; NCCL gathers on the card
        host = t.device.type == "cuda" and dist.get_backend(self.process_group) == "gloo"
        x = t.detach().cpu() if host else t.detach()
        counts = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
        all_counts = [torch.empty_like(counts) for _ in range(self.world_size)]
        dist.all_gather(all_counts, counts, group=self.process_group)
        all_counts = [int(c) for c in all_counts]
        most = max(all_counts)
        padded = x.new_zeros((most, *x.shape[1:]))
        padded[:x.shape[0]] = x
        parts = [torch.empty_like(padded) for _ in range(self.world_size)]
        dist.all_gather(parts, padded, group=self.process_group)
        out = torch.cat([p[:n] for p, n in zip(parts, all_counts)])
        return (out.to(t.device) if host else out), all_counts

    def broadcast_object(self, obj):
        """The main rank's ``obj`` (any picklable value), on every rank."""
        return self.broadcast_pickled(obj)[0]

    def broadcast_pickled(self, obj):
        """(the main rank's ``obj``, the bytes of its pickle) on every rank;
        the other ranks' ``obj`` is ignored. Two broadcasts: the length,
        then the bytes (on the card under NCCL, in host memory under
        gloo)."""
        if self.world_size == 1:
            return obj, 0
        import torch.distributed as dist

        dev = self._collective_device()
        if self.is_main:
            data = torch.frombuffer(bytearray(pickle.dumps(obj, pickle.HIGHEST_PROTOCOL)), dtype=torch.uint8)
            size = torch.tensor([data.numel()], dtype=torch.int64, device=dev)
        else:
            size = torch.zeros(1, dtype=torch.int64, device=dev)
        dist.broadcast(size, src=0, group=self.process_group)
        n = int(size.item())
        buf = data.to(dev) if self.is_main else torch.empty(n, dtype=torch.uint8, device=dev)
        dist.broadcast(buf, src=0, group=self.process_group)
        return (obj if self.is_main else pickle.loads(buf.cpu().numpy().tobytes())), n

    def any_true(self, flag: bool) -> bool:
        """Whether ``flag`` is true on any rank (one small all-reduce), so
        that every rank can raise where one rank failed."""
        if self.world_size == 1:
            return bool(flag)
        import torch.distributed as dist

        t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=self._collective_device())
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.process_group)
        return bool(t.item())

    def _collective_device(self) -> torch.device:
        """Where a small collective's tensor lives: the card under NCCL,
        host memory under gloo."""
        import torch.distributed as dist

        return self.device if dist.get_backend(self.process_group) == "nccl" else torch.device("cpu")


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out, counts = group._gather_rows(t)
        start = sum(counts[:group.rank])
        ctx.rows = slice(start, start + t.shape[0])
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _sum_over(t, group)

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad, ctx.group), None


def _sum_over(t: torch.Tensor, group: DataParallelGroup) -> torch.Tensor:
    import torch.distributed as dist

    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group.process_group)
    return out


def all_reduce_sum(t: torch.Tensor, group: DataParallelGroup | None) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks, in ``t``'s dtype, on every rank
    (``t`` itself without a group of several ranks). Differentiable: the
    gradient of ``t`` is the result's gradient summed over the ranks."""
    if group is None or group.world_size == 1:
        return t
    return _AllReduceSum.apply(t, group)


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


def init_group_from_env(device="cuda") -> DataParallelGroup:
    """Join the group ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``, ``init_method="env://"``):
    NCCL on ``cuda:<LOCAL_RANK>`` when ``device`` is a CUDA device (raises
    without one), gloo on the CPU when it is the CPU."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_group_from_env: no CUDA device; pass device='cpu' for gloo on the CPU")
        return init_group("env://", world, rank, "nccl", f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}")
    return init_group("env://", world, rank, "gloo", "cpu")


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
