"""Process bring-up, the collectives of a mesh split over processes, per-host
product staging and sub-box ownership (counterpart of
pinocchio_tpu/parallel/multihost.py).

The reference's process model is MPI_Init and the hypercube exchange of the
products (pinocchio.c:41-52, distribute.c:58-175).  Here a run over H hosts
is either H processes, one per host, joined in a torch.distributed process
group (initialize_cluster; process mode), or one process that mocks the
hosts one after another (run_pipeline(hosts=(h, H)) over an ordinary mesh).
Either way host h holds the contiguous block of the mesh's flat positions
that exchange.host_of_device_default gives it (pfft.host_blocks), so the two
split the mesh the same way.  In process mode a mesh position plays the role
of the JAX package's _spatial_key: a shard is known by its position, whose
real block and k window the decomposition gives, not by an index into a
global array.

The group runs on gloo, on the CPU and on the card alike: every collective
here stages its tensors through host memory (page-locked for a card's
shards, handoff.host_empty), one explicit copy each way, and TRAFFIC counts
each kind's bytes, seconds and calls.  NCCL, which needs a card of its own
for every rank, is not used (ROADMAP.md, item 12b-iv).  A collective that
fails raises: a peer that dies or never joins fails the others within the
group's timeout, and nothing falls back to a local result.

Every rank issues the collectives of one group in the same order, so two
threads must not share a group.  initialize_cluster therefore makes a
second gloo group, rows_group(), for the out-of-core engine's row streams,
which run on a background thread (handoff.PendingFetch) while the main
thread's sweeps and writers use the default group.

A host owns the fragmentation sub-boxes dealt to it round-robin and takes
its products from the exchange (parallel/exchange.py), or, where the
exchange does not apply, from its own devices' shards of the deferred
hand-off.  Each host writes its outputs as .out.<host> chunks through a
staging directory of its own, and scripts/torch_merge_chunks.py
reassembles them.
"""

from __future__ import annotations

import datetime
import math
import socket
import threading
import time
from typing import Callable

import numpy as np
import torch

from .. import kernels
from ..fmax import ensure_host_products
from ..handoff import host_empty

# bytes through the group (out of and into this process), seconds and calls
# of each kind of collective: the mesh transposes, the exchange's route, the
# gathers (whole fields, the spheres, the exchange's counts), the
# reductions, and the out-of-core engine's x-slab gathers, spectrum pieces
# and hand-off (keys, positions and landing rows)
TRAFFIC = {kind: dict(bytes=0, seconds=0.0, calls=0)
           for kind in ("transpose", "route", "gather", "reduce", "slab",
                        "spec", "handoff")}
_TRAFFIC_LOCK = threading.Lock()
# the second group of the process group (rows_group)
_ROWS = {}


def _count(kind: str, nbytes: int, t0: float) -> None:
    with _TRAFFIC_LOCK:
        rec = TRAFFIC[kind]
        rec["bytes"] += int(nbytes)
        rec["seconds"] += time.perf_counter() - t0
        rec["calls"] += 1


def initialize_cluster(nhosts: int = None, coordinator: str = None,
                       process_id: int = None, timeout: float = 1800.0,
                       verbose: bool = True) -> tuple:
    """The process group's bring-up (the MPI_Init_thread analog,
    pinocchio.c:41-52): with nhosts > 1, torch.distributed's gloo group of
    nhosts processes at tcp://<coordinator> (host:port, the address of
    process 0, which serves the rendezvous), this one ranked process_id;
    every collective, the rendezvous included, raises after ``timeout``
    seconds; then the second group of the same processes (rows_group),
    which every rank creates here in the same order.  A no-op for one
    process.  Returns (host_id, nhosts)."""
    import torch.distributed as dist
    if nhosts and nhosts > 1:
        if coordinator is None or process_id is None:
            raise ValueError("a run over several processes needs the "
                             "coordinator's host:port and this process's id")
        if not 0 <= process_id < nhosts:
            raise ValueError(f"process id {process_id} outside [0, "
                             f"{nhosts})")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}", world_size=nhosts,
            rank=process_id, timeout=datetime.timedelta(seconds=timeout))
        _ROWS["group"] = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=timeout))
    group = process_group()
    hid, n = group if group is not None else (0, 1)
    if verbose and n > 1:
        local = torch.cuda.device_count() if torch.cuda.is_available() else 1
        print(f"[cluster] process {hid}/{n} up, {local} local device(s)",
              flush=True)
    return hid, n


def shutdown_cluster() -> None:
    """Destroy the process group and its rows group (the MPI_Finalize
    analog); a no-op outside process mode."""
    import torch.distributed as dist
    _ROWS.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_group():
    """(rank, size) of this process in its process group, or None outside
    process mode."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


def rows_group():
    """The second gloo group of the processes (initialize_cluster), on which
    the out-of-core engine's row streams issue their collectives."""
    if "group" not in _ROWS:
        raise RuntimeError("the process group has no rows group: bring it "
                           "up with initialize_cluster")
    return _ROWS["group"]


def require_group(procs: tuple) -> None:
    """Raise unless this process is rank procs[0] of a group of procs[1]
    (a mesh made for a group that is not up, or for another one)."""
    group = process_group()
    if group != tuple(procs):
        raise RuntimeError(f"a mesh split over {procs[1]} processes as "
                           f"rank {procs[0]}, but this process's group is "
                           + ("not initialized (initialize_cluster)"
                              if group is None else f"{group}"))


def node_processes() -> int:
    """The processes of the group on this process's node (host name),
    itself included; 1 outside process mode."""
    if process_group() is None:
        return 1
    name = np.frombuffer(socket.gethostname().encode()[:255].ljust(255),
                         np.uint8)
    return sum(bool(np.array_equal(n[0], name))
               for n in all_gather_rows("gather", name[None]))


def barrier() -> None:
    import torch.distributed as dist
    t0 = time.perf_counter()
    dist.barrier()
    _count("reduce", 0, t0)


def all_sum(kind: str, arr: np.ndarray) -> np.ndarray:
    """The elementwise sum of a numpy array over the group (one all_reduce
    of a host tensor).  An entry that one process alone fills, the others
    holding 0, comes back exactly."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    t = torch.from_numpy(np.ascontiguousarray(arr)).clone()
    dist.all_reduce(t)
    _count(kind, 2 * t.numel() * t.element_size(), t0)
    return t.numpy()


def all_gather_rows(kind: str, rows: np.ndarray) -> list:
    """Every process's rows [n_r, ...] (any n_r, the same trailing shape and
    dtype), in rank order: the sizes first, then one all_gather of the rows
    padded to the largest."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    _, world = process_group()
    rows = np.ascontiguousarray(rows)
    n = torch.tensor([len(rows)], dtype=torch.int64)
    sizes = [torch.empty_like(n) for _ in range(world)]
    dist.all_gather(sizes, n)
    sizes = [int(s) for s in sizes]
    pad = np.zeros((max(sizes),) + rows.shape[1:], rows.dtype)
    pad[:len(rows)] = rows
    mine = torch.from_numpy(pad)
    got = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(got, mine)
    _count(kind, mine.numel() * mine.element_size() * world, t0)
    return [g.numpy()[:s] for g, s in zip(got, sizes)]


def all_to_all_staged(kind: str, send: dict, recv: dict, dtype,
                      group=None) -> dict:
    """One all_to_all_single of the group, staged through host memory:
    send {rank: [tensors]} (any device, any strides) goes to each rank in
    order; recv {rank: [(shape, device)]} names what each rank sends here,
    in its order.  Returns {rank: [tensors]}, each on its device.  Every
    tensor is of ``dtype``; the staging buffers are page-locked when a
    tensor lives on a card (handoff.host_empty), and the copies into and
    out of them block.  Every rank of ``group`` (None: the default group;
    rows_group() for the row streams) calls it, also one that sends and
    receives nothing."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    _, world = process_group()
    esize = torch.empty(0, dtype=dtype).element_size()
    out_n = [sum(t.numel() for t in send.get(r, ())) * esize
             for r in range(world)]
    in_n = [sum(math.prod(s) for s, _ in recv.get(r, ())) * esize
            for r in range(world)]
    devs = [t.device for ts in send.values() for t in ts] + \
        [d for specs in recv.values() for _, d in specs]
    stage = next((d for d in devs if d.type == "cuda"), "cpu")
    sendbuf = host_empty((sum(out_n),), torch.uint8, stage)
    off = 0
    for r in range(world):
        for t in send.get(r, ()):
            n = t.numel() * esize
            sendbuf[off:off + n].view(dtype).view(t.shape).copy_(t)
            off += n
    recvbuf = host_empty((sum(in_n),), torch.uint8, stage)
    dist.all_to_all_single(recvbuf, sendbuf, in_n, out_n, group=group)
    got, off = {}, 0
    for r in range(world):
        got[r] = []
        for shape, dev in recv.get(r, ()):
            n = math.prod(shape) * esize
            got[r].append(recvbuf[off:off + n].view(dtype).view(shape)
                          .to(dev))
            off += n
    _count(kind, sum(out_n) + sum(in_n), t0)
    return got


def resident_gib() -> float:
    """This process's resident set (VmRSS), GiB."""
    with open("/proc/self/status") as fd:
        for line in fd:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2 ** 20
    raise RuntimeError("no VmRSS in /proc/self/status")


class ResidentPeak:
    """The resident set of this process when the block starts (``start``)
    and its largest while the block runs (``peak``), sampled every
    ``period`` seconds by a thread, GiB (a container's /proc may lack
    VmHWM, and ru_maxrss keeps the forking parent's)."""

    def __init__(self, period: float = 0.01):
        self.period = period

    def __enter__(self):
        self.start = self.peak = resident_gib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(self.period):
            self.peak = max(self.peak, resident_gib())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, resident_gib())


def process_report(mesh, timings: dict, wall: float, plan: dict = None,
                   resident: ResidentPeak = None) -> dict:
    """One process's account of its run over the group of ``mesh``: its
    host id, wall and phase timings (seconds), the kernels it launched
    (kernels.LAUNCHES), the peak memory allocated on its cards (GiB, 0 on
    the CPU), its resident set at the run's start and its peak (GiB,
    ``resident``) beside the planner's host estimate for its node
    (``plan``, planner.plan's report) and TRAFFIC."""
    peak = max([torch.cuda.max_memory_allocated(d)
                for d in mesh.local_devices() if d.type == "cuda"] or [0])
    return dict(host=mesh.procs[0], nhosts=mesh.procs[1], wall_s=wall,
                timings=timings,
                launches={k: v for k, v in kernels.LAUNCHES.items() if v},
                device_peak_gib=peak / 2 ** 30,
                host_start_gib=None if resident is None else resident.start,
                host_peak_gib=None if resident is None else resident.peak,
                planned_host_gib=(None if plan is None
                                  else plan["host_bytes"] / 2 ** 30),
                node_processes=None if plan is None else plan["node_procs"],
                traffic=TRAFFIC)


def host_subboxes(geoms: list, host_id: int, nhosts: int) -> list:
    """Round-robin sub-box ownership (the task-to-sub-box assignment of
    initialization.c:995-1009)."""
    return geoms[host_id::nhosts]


def fetch_local_sparse(fmax_result, device_filter: Callable = None):
    """A host's share of the products: the needed rows of the shards whose
    mesh position i passes device_filter(i) (every shard when None), from
    the deferred hand-off of a mesh run, with global cell indices in the
    sweep's order and every displacement set.  Without a deferred hand-off
    (one device, a dump) the whole products; a filter there raises.  Over a
    mesh split over processes only this process's shards can be read: a
    filter must keep no other."""
    handoff = fmax_result.handoff
    if handoff is None:
        if device_filter is not None:
            raise ValueError("a device filter needs a mesh run's deferred "
                             "hand-off")
        return ensure_host_products(fmax_result)
    from .driver import merge_parts
    decomp = handoff.decomp
    own = [i for i in range(decomp.p)
           if device_filter is None or device_filter(i)]
    if not own:
        raise ValueError("the device filter keeps no shard")
    if any(not decomp.mesh.local(i) for i in own):
        raise ValueError("the products of another process's shards are not "
                         "here: a mesh split over processes reads its own "
                         "shards, and the others' rows come by the exchange")
    return merge_parts([handoff.shard_products(i) for i in own], decomp.N)
