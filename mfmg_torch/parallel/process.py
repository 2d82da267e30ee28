"""The process layer of the port's distribution: one rank per process over
``torch.distributed``.

Counterpart of the device mesh of mfmg_tpu/parallel/ (``jax.sharding.Mesh``
over the devices of one or several ``jax.distributed`` processes).  Here a
rank is one process with one ``torch.device``; ``Mesh`` holds the process
group, the shape of the process grid (``(P,)`` for slabs, ``(Pz, Py)`` for
pencils), this rank's coordinates in it (C order: rank = iz * Py + iy) and
the rank's device.

The backend is the caller's explicit choice, made before the group starts:

* ``"gloo"`` for ranks on the CPU, and for several ranks sharing one card:
  NCCL refuses two ranks on one device, so their halos and gathers go
  through pinned host buffers (device -> host copy, gloo point-to-point or
  all-gather, host -> device copy);
* ``"nccl"`` where each rank has its own card (``launch`` raises when the
  world is larger than ``torch.cuda.device_count()``): CUDA tensors go
  straight through ``dist.batch_isend_irecv`` and ``dist.all_gather``.

Nothing falls back from one to the other.  ``launch`` starts ``n`` local
ranks (``torch.multiprocessing`` with the spawn start method), each joining
a group that rendezvouses through a file in a temporary directory, so that
concurrent launches never race for a TCP port; a failed or hung rank makes
it raise within the timeout it is given.

Every point-to-point exchange and gather adds to ``Mesh.stats``: the
exchanges, the bytes a rank sends in them, and the bytes of its gathers.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass
class Mesh:
    """One rank's view of the process grid (see the module docstring)."""

    shape: tuple
    coords: tuple
    rank: int
    size: int
    device: torch.device
    backend: str
    group: object = None               # None: the default group
    stats: dict = dataclasses.field(default_factory=lambda: dict(
        exchanges=0, halo_bytes=0, gather_bytes=0))
    _pinned: dict = dataclasses.field(default_factory=dict, repr=False)

    def reshaped(self, shape) -> "Mesh":
        """The same ranks as another process grid (C order)."""
        shape = tuple(int(p) for p in shape)
        if int(np.prod(shape)) != self.size:
            raise ValueError(f"mesh_shape {shape} does not match the "
                             f"{self.size} ranks")
        coords = tuple(int(c) for c in np.unravel_index(self.rank, shape))
        return dataclasses.replace(self, shape=shape, coords=coords,
                                   stats=self.stats, _pinned=self._pinned)

    def neighbor(self, axis: int, step: int):
        """The rank at coordinate coords[axis] + step, or None off the grid."""
        c = list(self.coords)
        c[axis] += step
        if not 0 <= c[axis] < self.shape[axis]:
            return None
        return int(np.ravel_multi_index(c, self.shape))

    def reset_stats(self) -> None:
        for k in self.stats:
            self.stats[k] = 0

    @property
    def staged(self) -> bool:
        """Halos and gathers of CUDA tensors go through host buffers."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _host(self, tag, like: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer shaped like ``like``, one per tag and shape."""
        key = (tag, tuple(like.shape), like.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf


def make_mesh(device="cuda", group=None) -> Mesh:
    """This rank's Mesh of shape (P,) over an initialized process group (the
    default one unless ``group`` is given; ``Mesh.reshaped`` makes pencils):
    ``device`` the rank's device, the card by default (cuda:rank under NCCL,
    the current card under gloo); pass "cpu" for ranks on the CPU."""
    from mfmg_torch.utils.device import checked_device
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: start the "
                           "ranks with mfmg_torch.parallel.launch or call "
                           "init_process_group first")
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    backend = str(dist.get_backend(group)).lower()
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; the port takes {BACKENDS}")
    device = checked_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count()
                              if backend == "nccl" else torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device per rank")
    return Mesh(shape=(size,), coords=(rank,), rank=rank, size=size,
                device=device, backend=backend, group=group)


# --------------------------------------------------------------- collectives

def sendrecv(mesh: Mesh, sends, recvs) -> None:
    """Point-to-point exchange: ``sends`` [(peer rank, tensor)], ``recvs``
    [(peer rank, buffer)] filled in place; all posted together, then waited
    for.  Counts one exchange and the bytes sent."""
    if not sends and not recvs:
        return
    mesh.stats["exchanges"] += 1
    mesh.stats["halo_bytes"] += sum(t.numel() * t.element_size()
                                    for _, t in sends)
    if mesh.staged:
        hs = []
        for i, (peer, t) in enumerate(sends):
            h = mesh._host(("send", i), t)
            h.copy_(t)
            hs.append((peer, h))
        hr = [(peer, mesh._host(("recv", i), b)) for i, (peer, b) in enumerate(recvs)]
        _post(mesh, hs, hr)
        for (_, b), (_, h) in zip(recvs, hr):
            b.copy_(h)
        return
    _post(mesh, [(p, t.contiguous()) for p, t in sends], recvs)


def _post(mesh, sends, recvs):
    ops = ([dist.P2POp(dist.isend, t, _global(mesh, p), mesh.group) for p, t in sends]
           + [dist.P2POp(dist.irecv, b, _global(mesh, p), mesh.group) for p, b in recvs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def _global(mesh, rank):
    return rank if mesh.group is None else dist.get_global_rank(mesh.group, rank)


def all_gather(mesh: Mesh, t: torch.Tensor) -> list:
    """Every rank's tensor (same shape and dtype on all), in rank order, on
    this rank's device."""
    t = t.contiguous()
    mesh.stats["gather_bytes"] += t.numel() * t.element_size()
    if mesh.size == 1:
        return [t]
    if mesh.staged:
        h = mesh._host("gather", t)
        h.copy_(t)
        out = [torch.empty_like(h) for _ in range(mesh.size)]
        dist.all_gather(out, h, group=mesh.group)
        return [o.to(mesh.device) for o in out]
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(out, t, group=mesh.group)
    return out


def all_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of a same-shape tensor, added in rank order
    on every rank (one all-gather): every rank gets the same bits."""
    parts = all_gather(mesh, t)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


# ------------------------------------------------------------------- launch

def launch(fn, n: int, args=(), backend: str = "gloo", device="cuda",
           timeout: float = 600.0):
    """Run ``fn(mesh, *args)`` in ``n`` local ranks, one spawned process
    each, and return their results in rank order.

    backend "gloo" or "nccl", chosen here, before the group starts.
    device "cuda" (the default) or "cpu": under gloo every rank shares
    cuda:0 (halos and gathers through pinned host buffers) or takes the
    CPU; under nccl rank r takes cuda:r, and a world larger than the cards
    raises.  Each rank's torch takes an equal share of the cores.  ``fn``
    must be importable by name (a module-level function); its result is
    pickled back.  A rank that raises, exits or has not finished within
    ``timeout`` seconds makes this raise, every rank stopped."""
    import torch.multiprocessing as mp

    from mfmg_torch.utils.device import checked_device

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; the port takes {BACKENDS}")
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        if n > torch.cuda.device_count():
            raise ValueError(f"nccl: {n} ranks need {n} cards, this machine "
                             f"has {torch.cuda.device_count()}; several ranks "
                             f"on one card take backend='gloo'")
    device = checked_device(device)
    with tempfile.TemporaryDirectory(prefix="mfmg_ranks_") as tmp:
        # the call goes through a file: a spawn payload larger than a pipe's
        # buffer would make each start wait for the previous rank's imports
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        ctx = mp.start_processes(
            _rank_main, args=(n, tmp, backend, device.type, timeout),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks did not finish within "
                                       f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"),
                           weights_only=False) for r in range(n)]


def _rank_main(rank, n, tmp, backend, device_type, timeout):
    cores = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else os.cpu_count() or 1)
    torch.set_num_threads(max(1, cores // n))
    with open(os.path.join(tmp, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    if device_type == "cuda":
        device = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    kw = {}
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    try:
        out = fn(make_mesh(device=device), *args)
        torch.save(out, os.path.join(tmp, f"result_{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
