"""The device mesh and its collectives.

Counterpart of ``oryx_tpu/parallel/mesh.py`` (reference: the Spark
executors of AbstractSparkLayer.java:137-168, re-read as cards).  The
reference's mesh is a 1-D ``jax.sharding.Mesh``; here a ``Mesh`` is the
ordered tuple of ``torch.device`` entries this process drives, and, when
``oryx.distributed.*`` joins several processes, the ``torch.distributed``
process group that joins them (the counterpart of ``jax.distributed``:
NCCL between cards, gloo on the CPU).  Entry ``i`` of process ``r`` is
global entry ``r * local_size + i``; rows of a sharded array are split
over the global entries in that order.

The collectives are explicit functions beside the mesh, each over one
tensor per local entry:

- ``all_gather``: the entries' row blocks, tiled in global order, on
  every entry;
- ``psum``: the sum of the entries' tensors, on every entry;
- ``ppermute``: the ring's shift, entry ``g``'s block to entry
  ``g + 1`` (mod the mesh size).

Within a process they are device copies (``.to(d, non_blocking=True)``);
across processes ``dist.all_gather_into_tensor``, ``dist.all_reduce``
and a paired send and receive.  Work for an entry runs under
``common/device.device_context(d)``, so that each card's work is queued
on that card.

A mesh may repeat a device: two entries of ``cuda:0`` (or eight of the
CPU, as the reference's tests have eight virtual CPU devices) run the
same code that two cards run.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from ..common.device import resolve_device

__all__ = ["Mesh", "build_mesh", "local_mesh", "mesh_from_config",
           "initialize_multihost", "all_gather", "psum",
           "ppermute", "shard_rows", "pad_rows"]

# entries of a mesh over the CPU when the caller asks for the visible
# ones: the reference's tests run on 8 virtual CPU devices
# (tests/conftest.py's xla_force_host_platform_device_count)
CPU_ENTRIES = 8


class Mesh:
    """A 1-D mesh: the ``devices`` this process drives, in order, and the
    process ``group`` that joins several processes (None for one)."""

    def __init__(self, devices: Sequence, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one entry")
        self.group = group
        if group is not None:
            self.process_count = dist.get_world_size(group)
            self.process_index = dist.get_rank(group)
        else:
            self.process_count = 1
            self.process_index = 0

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """Global entry count: every process holds ``local_size``."""
        return self.local_size * self.process_count

    @property
    def first_entry(self) -> int:
        """Global index of this process's first entry."""
        return self.process_index * self.local_size

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"processes={self.process_count})")


def initialize_multihost(config=None, device=None) -> bool:
    """Join this process to a ``torch.distributed`` group, if configured.

    Config keys (all optional):
      oryx.distributed.coordinator-address   host:port of process 0
      oryx.distributed.num-processes
      oryx.distributed.process-id

    The group is NCCL when ``device`` (None means ``cuda``) is a card,
    gloo on the CPU, initialized at ``tcp://<coordinator-address>``.
    Returns True when the process is in a group: a no-op (False) when
    unconfigured, and a second call does nothing.  A failed join raises:
    training on one process when several were configured would be the
    worst failure mode."""
    coord = num = pid = None
    if config is not None:
        coord = config.get_optional_string(
            "oryx.distributed.coordinator-address")
        num = config.get_optional_int("oryx.distributed.num-processes")
        pid = config.get_optional_int("oryx.distributed.process-id")
    if coord is None and num is None and pid is None:
        return False
    if dist.is_initialized():
        return True
    if coord is None or num is None or pid is None:
        raise ValueError(
            "oryx.distributed.coordinator-address, "
            "oryx.distributed.num-processes and oryx.distributed.process-id "
            "are set together")
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        # NCCL binds a rank to the card current at its first collective
        torch.cuda.set_device(pid % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=num, rank=pid)
    return True


def _world_group():
    if dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def build_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A mesh over the first ``n_devices`` visible devices (all if None):
    the cards, or ``CPU_ENTRIES`` entries of the CPU for
    ``device="cpu"``.  ``device`` None means ``cuda``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        visible = [dev] * CPU_ENTRIES
    if n_devices is not None:
        if n_devices > len(visible):
            raise ValueError(f"requested {n_devices} devices but only "
                             f"{len(visible)} visible")
        visible = visible[:n_devices]
    return Mesh(visible, group=_world_group())


def local_mesh(device=None) -> Mesh:
    """Mesh over every device this process can see."""
    return build_mesh(None, device)


def mesh_from_config(config, device=None) -> Mesh | None:
    """The batch layer's training mesh, or None for one device.

    ``oryx.batch.streaming.master = "cpu"`` gives None.  Otherwise the
    process joins ``oryx.distributed.*`` first; then ``num-executors x
    executor-cores`` is the requested entry count (the reference's
    executor sizing, read as cards), shrunk to the cards present; one
    entry or fewer gives None.  On the CPU (``device="cpu"``) only
    ``master = "mesh"`` makes a mesh, of CPU entries, as the reference
    meshes its virtual CPU devices only then.  Across processes each
    process drives one card, that of its process id."""
    master = config.get_string("oryx.batch.streaming.master")
    if master == "cpu":
        return None
    dev = resolve_device(device)
    initialize_multihost(config, dev)
    if dev.type == "cpu" and master != "mesh":
        return None
    group = _world_group()
    if group is not None and dev.type == "cuda":
        # every process's card must be in the mesh, or its peers wait
        # at the first collective: the executor sizing is advisory here
        return Mesh([torch.device("cuda", torch.cuda.current_device())],
                    group=group)
    requested = (config.get_int("oryx.batch.streaming.num-executors")
                 * config.get_int("oryx.batch.streaming.executor-cores"))
    visible = torch.cuda.device_count() if dev.type == "cuda" \
        else CPU_ENTRIES
    n = min(requested, visible)
    if n <= 1 and group is None:
        return None
    return build_mesh(max(1, n), dev)


# -- row sharding --------------------------------------------------------------

def pad_rows(n: int, n_entries: int) -> int:
    """``n`` rounded up to a multiple of the entry count (at least one
    row per entry)."""
    return max(n_entries, -(-n // n_entries) * n_entries)


def shard_rows(mesh: Mesh, array, dtype=None) -> list[torch.Tensor]:
    """This process's row blocks of a host array whose row count is a
    multiple of ``mesh.size``: one block per local entry, on its
    device."""
    t = torch.as_tensor(array)
    if dtype is not None:
        t = t.to(dtype)
    rows = t.shape[0] // mesh.size
    if rows * mesh.size != t.shape[0]:
        raise ValueError(f"{t.shape[0]} rows do not split over "
                         f"{mesh.size} entries")
    out = []
    for i, d in enumerate(mesh.devices):
        g = mesh.first_entry + i
        out.append(t[g * rows:(g + 1) * rows].to(d, non_blocking=True))
    return out


# -- collectives ---------------------------------------------------------------

def _on(t: torch.Tensor, d: torch.device) -> torch.Tensor:
    return t if t.device == d else t.to(d, non_blocking=True)


def all_gather(mesh: Mesh, blocks: Sequence[torch.Tensor]
               ) -> list[torch.Tensor]:
    """The global array whose row blocks the entries hold, on every
    local entry (the reference's tiled ``lax.all_gather``)."""
    d0 = mesh.devices[0]
    local = torch.cat([_on(b, d0) for b in blocks])
    if mesh.group is not None:
        full = torch.empty((mesh.process_count * local.shape[0],)
                           + tuple(local.shape[1:]), dtype=local.dtype,
                           device=d0)
        dist.all_gather_into_tensor(full, local.contiguous(),
                                    group=mesh.group)
    else:
        full = local
    return [_on(full, d) for d in mesh.devices]


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of every entry's tensor, on every local entry."""
    d0 = mesh.devices[0]
    total = _on(parts[0], d0).clone()
    for p in parts[1:]:
        total += _on(p, d0)
    if mesh.group is not None:
        dist.all_reduce(total, group=mesh.group)
    return [_on(total, d) for d in mesh.devices]


def ppermute(mesh: Mesh, blocks: Sequence[torch.Tensor]
             ) -> list[torch.Tensor]:
    """The ring's shift: global entry ``g`` receives the block of entry
    ``g - 1`` (mod the mesh size)."""
    n = mesh.local_size
    out: list[torch.Tensor | None] = [None] * n
    for i in range(1, n):
        out[i] = _on(blocks[i - 1], mesh.devices[i])
    if mesh.group is not None:
        world, rank = mesh.process_count, mesh.process_index
        last = blocks[-1].contiguous()
        recv = torch.empty_like(last, device=mesh.devices[0])
        ops = [dist.P2POp(dist.isend, _on(last, mesh.devices[0]),
                          (rank + 1) % world, group=mesh.group),
               dist.P2POp(dist.irecv, recv, (rank - 1) % world,
                          group=mesh.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out[0] = recv
    else:
        out[0] = _on(blocks[-1], mesh.devices[0])
    return out
