"""One mesh across processes (port of
``caltech_bifrost_dsp_tpu/parallel/multihost.py``).

The reference scales across 8-9 servers by running share-nothing
processes coordinated only through etcd (lwa352_xeng_etcd_client.py).  The
JAX package forms ONE global mesh across hosts under ``jax.distributed``.
Here the processes join a ``torch.distributed`` group, each owns some
shards of one ('time', 'chan') :class:`..parallel.mesh.Mesh`, and the
sharded programs of :mod:`.mesh` run unchanged in every process: each runs
its own shards, and a collective block whose source and destination lie
in two processes crosses through ``torch.distributed``.

The backend is the caller's choice and nothing is put in its place.  gloo
is the one that runs: its point-to-point calls take CPU tensors only, so a
CUDA block is staged through pinned host buffers (:meth:`.mesh.Mesh.
exchange`).  NCCL takes no two ranks on one device; it is accepted as a
name, and a mesh on it raises, since only the host-staged transport is
ported.

Host-edge IO stays local: each process ingests the channels its shards
own (:func:`local_channel_range`), and the arming arithmetic
(``utils/timeutils``) keeps integration boundaries aligned across
processes without data-plane communication.
"""

from __future__ import annotations

import datetime
import os
import warnings

import torch
import torch.distributed as dist

from .mesh import Mesh, _index, collective_volumes, held_at, unshard

BACKENDS = ("gloo", "nccl")
#: how long a rendezvous or a transfer waits for the other processes
TIMEOUT = datetime.timedelta(seconds=120)
ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str = "gloo") -> None:
    """Join the process group.

    Explicit ``num_processes <= 1`` is a no-op.  With all three left None
    the ``env://`` rendezvous is used (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``); where those are absent it warns and the
    process continues alone.  Otherwise the group meets at
    ``tcp://coordinator_address``.  A rendezvous or a transfer that waits
    longer than :data:`TIMEOUT` raises."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if num_processes is not None and num_processes <= 1:
        return
    if (coordinator_address is None and num_processes is None
            and process_id is None):
        missing = [k for k in ENV_VARS if k not in os.environ]
        if missing:
            warnings.warn(
                f"no env:// rendezvous ({', '.join(missing)} unset); "
                "continuing single-process: multi-process runs must set "
                "them or pass coordinator_address/num_processes/process_id")
            return
        dist.init_process_group(backend, init_method="env://",
                                timeout=TIMEOUT)
        return
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def _check_backend(backend: str, device_lists) -> None:
    """NCCL takes no two ranks on one device, and its transport is not
    ported: a mesh on it raises, saying which."""
    if backend != "nccl":
        return
    seen = {}
    for rank, devices in enumerate(device_lists):
        for d in devices:
            if d.startswith("cuda") and seen.get(d, rank) != rank:
                raise ValueError(f"ranks {seen[d]} and {rank} both name {d}: "
                                 "NCCL takes no two ranks on one device; "
                                 "use backend='gloo'")
            seen[d] = rank
    raise NotImplementedError("the cross-process transport is gloo staged "
                              "through host memory; NCCL across cards is "
                              "not ported")


def global_mesh(n_time: int | None = None, n_chan: int | None = None,
                placement: str = "chan", devices=None) -> Mesh:
    """('time', 'chan') mesh over the devices of every process.

    ``devices`` is this process's device list (default: every local CUDA
    device); it may name one device more than once, as
    :func:`.mesh.make_mesh` allows.  ``placement`` picks which axis spans
    processes:

    - ``"chan"`` (the production policy, SCALING.md §3): each chan column
      is one process's devices, so the visibilities of the X/B step never
      leave their process; the FX corner-turn and the VLBI gather cross.
    - ``"time"``: each time row is one process's devices; the visibility
      ``psum`` and the PFB halo cross.

    Devices are taken in rank order, then in each process's own order, as
    ``jax.devices()`` orders them.  The processes agree on the shape with
    one ``all_gather_object``."""
    if placement not in ("time", "chan"):
        raise ValueError(f"unknown placement {placement!r}")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    local = [str(torch.device(d)) for d in devices]
    ask = (n_time, n_chan, placement)
    if dist.is_initialized():
        views = [None] * dist.get_world_size()
        dist.all_gather_object(views, (local, ask))
        rank = dist.get_rank()
    else:
        views, rank = [(local, ask)], 0
    asks = {v[1] for v in views}
    if len(asks) != 1:
        raise ValueError(f"processes ask for different meshes: {asks}")
    lists = [v[0] for v in views]
    if dist.is_initialized():
        _check_backend(dist.get_backend(), lists)
    nproc = len(lists)
    flat = [(r, d) for r, lst in enumerate(lists) for d in lst]
    if placement == "chan":
        n_chan = n_chan or nproc
        n_time = n_time or len(flat) // n_chan
    else:
        n_time = n_time or nproc
        n_chan = n_chan or len(flat) // n_time
    if not n_time or not n_chan or n_time * n_chan > len(flat):
        raise ValueError(f"a {n_time}x{n_chan} mesh needs "
                         f"{(n_time or 1) * (n_chan or 1)} devices; the "
                         f"processes have {len(flat)}")

    def index(t, c):
        return c * n_time + t if placement == "chan" else t * n_chan + c

    grid = [flat[index(t, c)] for t in range(n_time) for c in range(n_chan)]
    if nproc == 1:
        return Mesh([d for _, d in grid], n_time, n_chan)
    return Mesh([d if r == rank else None for r, d in grid], n_time, n_chan,
                owners=[r for r, _ in grid])


def local_channel_range(cfg, mesh: Mesh) -> tuple[int, int]:
    """The global channel slice owned by this process's shards (for
    wiring each process's capture engine to its frequency shard)."""
    chan_per_shard = cfg.nchan // mesh.n_chan
    cols = sorted({c for _, c in mesh.local_coords()})
    return cols[0] * chan_per_shard, (cols[-1] + 1) * chan_per_shard


def process_allgather(sharded) -> torch.Tensor:
    """The global tensor of a :class:`.mesh.Sharded` in every process, on
    the CPU (the counterpart of ``jax.experimental.multihost_utils.
    process_allgather(x, tiled=True)``).  Each block is broadcast by the
    process that holds it (a value replicated over an axis is held at
    index 0 of it).  Call it outside the sharded programs, which join
    their streams before they return."""
    mesh = sharded.mesh
    if mesh.nproc == 1:
        return unshard(sharded, "cpu")
    blocks = sorted({held_at(sharded.spec, t, c) for t, c in mesh.coords()})
    first = blocks[0]
    meta = [(tuple(sharded.shape), sharded[first].dtype)
            if mesh.is_local(*first) else None]
    dist.broadcast_object_list(meta, src=mesh.owners[first[0]][first[1]])
    shape, dtype = meta[0]
    out = torch.empty(shape, dtype=dtype)
    for t, c in blocks:
        owner = mesh.owners[t][c]
        idx = _index(mesh, sharded.spec, shape, t, c)
        if owner == mesh.rank:
            buf = sharded[t, c].cpu().contiguous()
        else:
            buf = torch.empty(out[idx].shape, dtype=dtype)
        dist.broadcast(buf, src=owner)
        out[idx] = buf
    return out


def split_volumes(cfg, n_time: int, n_chan: int, placement: str) -> dict:
    """:func:`.mesh.collective_volumes` with each collective's bytes per
    window split into ``in_process_bytes_per_window`` and
    ``cross_process_bytes_per_window`` for the mesh :func:`global_mesh`
    builds by default: one process per index of the axis that
    ``placement`` spreads over the processes.  Every collective over that
    axis crosses processes; one over the other axis stays in its
    process."""
    if placement not in ("time", "chan"):
        raise ValueError(f"unknown placement {placement!r}")
    vols = collective_volumes(cfg, n_time, n_chan)
    for v in vols["collectives"]:
        total = v["total_bytes_per_window"]
        cross = total if v["mesh_axis"] == placement else 0
        v["cross_process_bytes_per_window"] = cross
        v["in_process_bytes_per_window"] = total - cross
    vols["placement"] = placement
    return vols
