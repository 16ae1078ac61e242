"""Distributed 3-D FFT and k-space multipliers over a mesh of devices in one
process or split over a process group (counterpart of
pinocchio_tpu/parallel/pfft.py).

A ``Mesh`` is a numpy object array of ``torch.device`` in the mesh's shape
with its axis names.  A sharded field is the list of its shard tensors in
row-major mesh order, each on its own device.  A mesh split over a process
group (``procs`` = (rank, size); mesh_for(procs=)) holds in each process
only the shards of the contiguous block of flat positions that
host_blocks gives its rank: the other positions' devices and shards are
None, the per-shard work runs on the local positions alone, and a chunk of
a transpose whose source and destination lie in two processes crosses in
one staged all_to_all of the group per transpose (multihost).

The three decompositions of the JAX package (the reference's
set_fft_decomposition, initialization.c:1205-1379), in global shapes, with
p the mesh size and Nh = N//2+1:

  slab    ('x')          real [N/p, N, N]             k [N, N/p, Nh]
  pencil  ('a','b')      real [N/pa, N/pb, N]         k [N, N/pa, Nhp/pb]
  volumes ('a','b','c')  real [N/pa, N/pb, N/pc]      k [N, N/pa, Nhp/(pb pc)]

where Nhp = g*ceil(Nh/g) (g = pb or pb*pc) pads the rfft half axis so that
its kz blocks split evenly; the padded planes stay exactly zero and are cut
off before the inverse z transform.  A transform is local ``torch.fft``
calls on each shard's device (cuFFT on a card) and tiled all_to_alls
within groups of the mesh: the whole mesh (slab), each row and column
(pencil), the 'c' lines, the b-major ('b','c') planes and the 'a' lines
(volumes).  The k-space multipliers are the shard kernels K2s, K5s and K8s,
each on its shard's window of the k layout.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..grids import irfft_z
from ..handoff import to_host
from ..ops import derivatives

AX = "x"    # mesh axis of the slab decomposition
AXA = "a"   # pencil mesh axes
AXB = "b"
AXC = "c"   # third axis of the volumes mesh


def host_blocks(p: int, nhosts: int) -> tuple:
    """Mesh position -> host of a mesh of p positions over nhosts hosts:
    contiguous blocks of the flat order (the layout a cluster's bring-up
    gives, each host's devices consecutive), of equal size when nhosts
    divides p."""
    return tuple(i * nhosts // p for i in range(p))


@dataclass(frozen=True, eq=False)
class Mesh:
    """Devices in the mesh's shape (a numpy object array of torch.device)
    and the mesh's axis names; procs (rank, size) for a mesh split over a
    process group, whose devices are None where another process holds the
    shard."""
    devices: np.ndarray
    axis_names: tuple
    procs: tuple = None

    def __post_init__(self):
        if self.procs is not None:
            rank, nproc = self.procs
            if self.size % nproc:
                raise ValueError(f"a mesh of {self.size} shards over "
                                 f"{nproc} processes")
            own = [self.owner(i) == rank for i in range(self.size)]
            if own != [d is not None for d in self.devices.flat]:
                raise ValueError(f"rank {rank}'s devices must be those of "
                                 "its block of the mesh, and only those")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def device_list(self) -> list:
        """The shards' devices in row-major mesh order (None where another
        process holds the shard)."""
        return list(self.devices.flat)

    def owner(self, i: int) -> int:
        """The rank of the process that holds shard i (0 in one process)."""
        if self.procs is None:
            return 0
        return host_blocks(self.size, self.procs[1])[i]

    def local(self, i: int) -> bool:
        """Whether this process holds shard i."""
        return self.procs is None or self.owner(i) == self.procs[0]

    def local_devices(self) -> list:
        """This process's distinct devices, in mesh order."""
        return list(dict.fromkeys(d for d in self.devices.flat
                                  if d is not None))

    def n_devices(self) -> int:
        """Distinct devices: the memory the mesh spreads over (each
        process's own, times the processes)."""
        return len(self.local_devices()) * (1 if self.procs is None
                                            else self.procs[1])


def _devices(n, devices) -> list:
    """The mesh's device list: ``devices`` as given (it may repeat a device;
    None marks another process's shard), or with n alone cuda:0..n-1,
    which must all exist."""
    if devices is not None:
        devs = [None if d is None else torch.device(d) for d in devices]
        if n is not None and n != len(devs):
            raise ValueError(f"a mesh of {n} devices with a list of "
                             f"{len(devs)}")
        return devs
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n is None:
        n = have
    if n < 1 or have < n:
        raise RuntimeError(f"a mesh of {n} CUDA devices was requested but "
                           f"{have} are available (only an explicit devices= "
                           "list may repeat a device)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n: int = None, devices=None) -> Mesh:
    """1-D (slab) mesh over n devices."""
    devs = _devices(n, devices)
    return Mesh(_array(devs, (len(devs),)), (AX,))


def make_pencil_mesh(n: int = None, shape: tuple = None,
                     devices=None) -> Mesh:
    """2-D (pencil) mesh; the factorization defaults to the most square
    pa x pb split (set_fft_decomposition's 2-D branch)."""
    devs = _devices(n, devices)
    n = len(devs)
    if shape is None:
        pa = int(math.sqrt(n))
        while n % pa:
            pa -= 1
        shape = (pa, n // pa)
    if shape[0] * shape[1] != n:
        raise ValueError(f"pencil mesh {shape} over {n} devices")
    return Mesh(_array(devs, tuple(shape)), (AXA, AXB))


def make_volume_mesh(n: int = None, shape: tuple = None,
                     devices=None) -> Mesh:
    """3-D (volumes) mesh; the factorization defaults to the most cubic
    pa x pb x pc split (the 3-D procmesh of set_fft_decomposition)."""
    devs = _devices(n, devices)
    n = len(devs)
    if shape is None:
        pa = round(n ** (1.0 / 3.0))
        while n % pa:
            pa -= 1
        rest = n // pa
        pb = int(math.sqrt(rest))
        while rest % pb:
            pb -= 1
        shape = tuple(sorted((pa, pb, rest // pb), reverse=True))
    if shape[0] * shape[1] * shape[2] != n:
        raise ValueError(f"volumes mesh {shape} over {n} devices")
    return Mesh(_array(devs, tuple(shape)), (AXA, AXB, AXC))


def mesh_for(n: int, decomp: str = "auto", devices=None,
             procs: tuple = None) -> Mesh:
    """The mesh of a run over n devices: --decomp slab, pencil or volumes,
    or auto, a pencil mesh for even counts from 4 on and a slab otherwise
    (the JAX package's run.py choice).  procs=(rank, size): the mesh split
    over the process group, n shards in all, of which this process holds
    its block of n / size on ``devices`` (that many; default cuda:0..n /
    size - 1, which must all exist)."""
    if procs is not None:
        rank, nproc = procs
        if n % nproc:
            raise ValueError(f"{nproc} processes do not divide a mesh of "
                             f"{n} shards")
        local = _devices(n // nproc, devices)
        devices = [local[i - rank * (n // nproc)] if o == rank else None
                   for i, o in enumerate(host_blocks(n, nproc))]
    if decomp == "slab":
        mesh = make_mesh(n, devices)
    elif decomp == "pencil":
        mesh = make_pencil_mesh(n, devices=devices)
    elif decomp == "volumes":
        mesh = make_volume_mesh(n, devices=devices)
    elif decomp != "auto":
        raise ValueError(f"unknown decomposition {decomp!r}")
    elif n >= 4 and n % 2 == 0:
        mesh = make_pencil_mesh(n, devices=devices)
    else:
        mesh = make_mesh(n, devices)
    return mesh if procs is None else dataclasses.replace(
        mesh, procs=tuple(procs))


def _array(devs, shape) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr.reshape(shape)


def all_to_all(shards: list, groups: list, split_axis: int,
               concat_axis: int, mesh: Mesh = None) -> list:
    """The tiled all_to_all of jax.lax within each group of shard indices:
    member j of a group receives chunk j (of the group's size, along
    split_axis) of every member's shard, concatenated along concat_axis in
    member order, on its own device.  Each chunk is a view copied with
    .to(non_blocking=True) (no copy at all when both shards are on one
    device) and torch.cat writes the result.  Over a mesh split over
    processes (``mesh``), each process assembles its own destinations, and
    the chunks whose source another process holds, or whose destination,
    cross in one staged all_to_all of the group (multihost.
    all_to_all_staged); every process takes part whenever any chunk of the
    groups crosses processes, as every process can tell from the mesh."""
    own = mesh.owner if mesh is not None else (lambda i: 0)
    rank = mesh.procs[0] if mesh is not None and mesh.procs else 0
    g = len(groups[0])
    chunks = {i: torch.chunk(shards[i], g, dim=split_axis)
              for group in groups for i in group if own(i) == rank}
    send, recv = {}, {}
    for group in groups:
        for j, dst in enumerate(group):
            for src in group:
                if own(src) == rank and own(dst) != rank:
                    send.setdefault(own(dst), []).append(chunks[src][j])
                elif own(dst) == rank and own(src) != rank:
                    recv.setdefault(own(src), []).append(
                        (chunks[dst][j].shape, shards[dst].device))
    got = {}
    if any(own(src) != own(dst) for group in groups for src in group
           for dst in group):
        from .multihost import all_to_all_staged
        some = chunks[next(iter(chunks))][0]
        got = {r: iter(v) for r, v in all_to_all_staged(
            "transpose", send, recv, some.dtype).items()}
    out = [None] * len(shards)
    for group in groups:
        for j, dst in enumerate(group):
            if own(dst) != rank:
                continue
            dev = shards[dst].device
            out[dst] = torch.cat(
                [chunks[src][j].to(dev, non_blocking=True)
                 if own(src) == rank else next(got[own(src)])
                 for src in group], dim=concat_axis)
    return out


def _each(fn, shards: list) -> list:
    """fn of every shard this process holds; None at the others."""
    return [None if t is None else fn(t) for t in shards]


def _pad_z(k, Nhp: int):
    """k [..., Nh] zero-padded to [..., Nhp]."""
    pad = Nhp - k.shape[-1]
    if pad == 0:
        return k
    return torch.cat([k, k.new_zeros(k.shape[:-1] + (pad,))], dim=-1)


class _Decomp:
    """What the three decompositions share: the mesh's groups, each shard's
    real block and k window, the scatter and gather of whole fields (tests,
    dense products) and the per-shard map.  Fields carry any leading batch
    dimensions before their three spatial axes."""

    def __init__(self, mesh: Mesh, N: int, Nhp: int):
        self.mesh, self.N = mesh, N
        self.Nh = N // 2 + 1
        self.Nhp = Nhp
        self.devices = mesh.device_list()
        self.p = mesh.size
        self.local = [i for i in range(self.p) if mesh.local(i)]
        self.k_global_shape = (N, N, Nhp)
        if mesh.procs is not None:
            from .multihost import require_group
            require_group(mesh.procs)

    def groups(self, axes) -> list:
        """The shard groups of a collective over ``axes`` (a name or a
        tuple, enumerated row-major over the tuple: b-major for
        ('b', 'c')): one list of flat shard indices per group."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        names = list(self.mesh.axis_names)
        idx = np.arange(self.p).reshape(self.mesh.devices.shape)
        order = [names.index(a) for a in names if a not in axes] + \
            [names.index(a) for a in axes]
        size = math.prod(idx.shape[names.index(a)] for a in axes)
        return idx.transpose(order).reshape(-1, size).tolist()

    def map(self, fn, *fields) -> list:
        """[fn(i, field_0[i], ...)] for every shard i this process holds,
        each under its device (kernels.on_device); None at the others."""
        out = [None] * self.p
        for i in self.local:
            with kernels.on_device(self.devices[i]):
                out[i] = fn(i, *(f[i] for f in fields))
        return out

    def all_to_all(self, shards, axes, split_axis, concat_axis) -> list:
        """all_to_all within the groups of the collective over ``axes``."""
        return all_to_all(shards, self.groups(axes), split_axis, concat_axis,
                          self.mesh)

    # each shard's blocks: real (x0, nx, y0, ny, z0, nz) and k (y0, ny,
    # z0, nz) of the [N, N, Nhp] layout
    def real_block(self, i: int) -> tuple:
        raise NotImplementedError

    def k_window(self, i: int) -> tuple:
        raise NotImplementedError

    def scatter(self, full, kspace: bool = False) -> list:
        """A whole field [..., N, N, N] (real) or [..., N, N, Nh] (k, padded
        to Nhp here), a tensor or numpy array, as shards on the mesh (this
        process's; every process of a group holds the whole field)."""
        if isinstance(full, np.ndarray):
            full = torch.from_numpy(np.array(full))
        if kspace:
            full = _pad_z(full, self.Nhp)
        return self.map(lambda i, dev: full[(Ellipsis,) + self._block(
            i, kspace)].to(dev).contiguous(), self.devices)

    def gather(self, shards: list, kspace: bool = False) -> np.ndarray:
        """The whole field on the host as numpy, [..., N, N, N] (real) or
        [..., N, N, Nhp] (k), from each shard's page-locked host copy
        (handoff.to_host); over a mesh split over processes, in every
        process, the blocks crossing in one all_gather of the group."""
        some = next(s for s in shards if s is not None)
        lead = tuple(some.shape[:-3])
        last = self.Nhp if kspace else self.N
        host = {i: to_host(shards[i]).numpy() for i in self.local}
        dtype = host[self.local[0]].dtype
        if self.mesh.procs is not None:
            from .multihost import all_gather_rows
            mine = np.stack([host[i] for i in self.local])
            parts = all_gather_rows("gather", mine)
            host = {}
            for r, part in enumerate(parts):
                mine_r = [i for i in range(self.p) if self.mesh.owner(i) == r]
                host.update(zip(mine_r, part))
        full = np.empty(lead + (self.N, self.N, last), dtype)
        for i, h in host.items():
            full[(Ellipsis,) + self._block(i, kspace)] = h
        return full

    def _block(self, i: int, kspace: bool) -> tuple:
        """The slices of shard i's block of the whole field."""
        if kspace:
            y0, ny, z0, nz = self.k_window(i)
            return (slice(y0, y0 + ny), slice(z0, z0 + nz))
        x0, nx, y0, ny, z0, nz = self.real_block(i)
        return (slice(x0, x0 + nx), slice(y0, y0 + ny), slice(z0, z0 + nz))


class SlabDecomp(_Decomp):
    """1-D decomposition: one all_to_all over the mesh per transform."""

    def __init__(self, mesh: Mesh, N: int):
        if tuple(mesh.axis_names) != (AX,):
            raise ValueError("a slab decomposition needs a 1-D mesh")
        super().__init__(mesh, N, N // 2 + 1)
        if N % self.p:
            raise ValueError("slab needs N % n_devices == 0")
        self.m = N // self.p

    def real_block(self, i):
        return (i * self.m, self.m, 0, self.N, 0, self.N)

    def k_window(self, i):
        return (i * self.m, self.m, 0, self.Nh)

    def fwd(self, shards):
        """real [..., N/p, N, N] -> k [..., N, N/p, Nh]."""
        k = _each(lambda r: torch.fft.fft(torch.fft.rfft(r, dim=-1), dim=-2),
                  shards)
        k = self.all_to_all(k, AX, -2, -3)
        return _each(lambda t: torch.fft.fft(t, dim=-3).contiguous(), k)

    def inv(self, shards):
        """k [..., N, N/p, Nh] -> real [..., N/p, N, N]."""
        k = _each(lambda t: torch.fft.ifft(t, dim=-3), shards)
        k = self.all_to_all(k, AX, -3, -2)
        return _each(lambda t: irfft_z(torch.fft.ifft(t, dim=-2), self.N)
                     .contiguous(), k)


class PencilDecomp(_Decomp):
    """2-D decomposition: two subgroup all_to_alls per transform, within
    each mesh row ('b') and each column ('a')."""

    def __init__(self, mesh: Mesh, N: int):
        if tuple(mesh.axis_names) != (AXA, AXB):
            raise ValueError("a pencil decomposition needs an (a, b) mesh")
        pa, pb = mesh.devices.shape
        Nh = N // 2 + 1
        super().__init__(mesh, N, pb * ((Nh + pb - 1) // pb))
        if N % pa or N % pb:
            raise ValueError("pencil needs N divisible by both mesh dims")
        self.pa, self.pb = pa, pb

    def real_block(self, i):
        a, b = divmod(i, self.pb)
        mx, my = self.N // self.pa, self.N // self.pb
        return (a * mx, mx, b * my, my, 0, self.N)

    def k_window(self, i):
        a, b = divmod(i, self.pb)
        my, mz = self.N // self.pa, self.Nhp // self.pb
        return (a * my, my, b * mz, mz)

    def fwd(self, shards):
        """real [..., N/pa, N/pb, N] -> k [..., N, N/pa, Nhp/pb]."""
        k = _each(lambda r: _pad_z(torch.fft.rfft(r, dim=-1), self.Nhp),
                  shards)
        # row transpose: gather y, scatter kz within each 'b' group
        k = self.all_to_all(k, AXB, -1, -2)
        k = _each(lambda t: torch.fft.fft(t, dim=-2), k)
        # column transpose: gather x, scatter ky within each 'a' group
        k = self.all_to_all(k, AXA, -2, -3)
        return _each(lambda t: torch.fft.fft(t, dim=-3).contiguous(), k)

    def inv(self, shards):
        """k [..., N, N/pa, Nhp/pb] -> real [..., N/pa, N/pb, N]."""
        k = _each(lambda t: torch.fft.ifft(t, dim=-3), shards)
        k = self.all_to_all(k, AXA, -3, -2)
        k = _each(lambda t: torch.fft.ifft(t, dim=-2), k)
        k = self.all_to_all(k, AXB, -2, -1)
        return _each(lambda t: irfft_z(t[..., :self.Nh], self.N)
                     .contiguous(), k)


class VolumeDecomp(_Decomp):
    """3-D (volumes) decomposition: three subgroup all_to_alls per
    transform.  The forward transform gathers z within each 'c' line
    (scattering y), transforms z, gathers y across the b-major ('b','c')
    plane (scattering kz), transforms y, then gathers x within each 'a'
    line (scattering ky) and transforms x."""

    def __init__(self, mesh: Mesh, N: int):
        if tuple(mesh.axis_names) != (AXA, AXB, AXC):
            raise ValueError("a volumes decomposition needs an (a, b, c) "
                             "mesh")
        pa, pb, pc = mesh.devices.shape
        pbc = pb * pc
        Nh = N // 2 + 1
        super().__init__(mesh, N, pbc * ((Nh + pbc - 1) // pbc))
        if N % pa or N % pb or (N // pb) % pc:
            raise ValueError("volumes needs N % pa == 0 and (N/pb) % pc "
                             "== 0")
        self.pa, self.pb, self.pc = pa, pb, pc

    def real_block(self, i):
        ab, c = divmod(i, self.pc)
        a, b = divmod(ab, self.pb)
        mx, my, mz = self.N // self.pa, self.N // self.pb, self.N // self.pc
        return (a * mx, mx, b * my, my, c * mz, mz)

    def k_window(self, i):
        a, bc = divmod(i, self.pb * self.pc)
        my, mz = self.N // self.pa, self.Nhp // (self.pb * self.pc)
        return (a * my, my, bc * mz, mz)

    def fwd(self, shards):
        """real [..., N/pa, N/pb, N/pc] -> k [..., N, N/pa, Nhp/(pb pc)]."""
        k = self.all_to_all(shards, AXC, -2, -1)
        k = _each(lambda r: _pad_z(torch.fft.rfft(r, dim=-1), self.Nhp), k)
        k = self.all_to_all(k, (AXB, AXC), -1, -2)
        k = _each(lambda t: torch.fft.fft(t, dim=-2), k)
        k = self.all_to_all(k, AXA, -2, -3)
        return _each(lambda t: torch.fft.fft(t, dim=-3).contiguous(), k)

    def inv(self, shards):
        """k [..., N, N/pa, Nhp/(pb pc)] -> real [..., N/pa, N/pb, N/pc]."""
        k = _each(lambda t: torch.fft.ifft(t, dim=-3), shards)
        k = self.all_to_all(k, AXA, -3, -2)
        k = _each(lambda t: torch.fft.ifft(t, dim=-2), k)
        k = self.all_to_all(k, (AXB, AXC), -2, -1)
        r = _each(lambda t: irfft_z(t[..., :self.Nh], self.N), k)
        return _each(lambda t: t.contiguous(),
                     self.all_to_all(r, AXC, -1, -2))


def make_decomp(mesh: Mesh, N: int) -> _Decomp:
    naxes = len(mesh.axis_names)
    return (VolumeDecomp(mesh, N) if naxes == 3
            else PencilDecomp(mesh, N) if naxes == 2
            else SlabDecomp(mesh, N))


# ---------------- distributed transforms and derivatives ----------------

def distributed_rfft3(decomp, shards) -> list:
    """Forward transform: real shards -> k shards."""
    return decomp.fwd(shards)


def distributed_irfft3(decomp, shards) -> list:
    """Inverse transform: k shards -> real shards (1/N^3 convention)."""
    return decomp.inv(shards)


def distributed_second_derivatives(decomp, kden, R_grid: float) -> list:
    """The 6 Hessian components of the smoothed potential from delta(k)
    shards: K2s on each shard's k window, one batched inverse transform;
    real shards [6, *block] in ider order."""
    N = decomp.N
    return decomp.inv(decomp.map(
        lambda i, k: derivatives.hessian_kspace_shard(
            k, R_grid, N, *_origin(decomp, i)), kden))


def distributed_first_derivatives(decomp, kvec, growth: float) -> list:
    """The 3 first derivatives i k_a / k^2 * growth of k shards (one
    displacement field): K5s, then one batched inverse transform; real
    shards [3, *block]."""
    N = decomp.N
    return decomp.inv(decomp.map(
        lambda i, k: derivatives.gradient_kspace_shard(
            k, growth, N, *_origin(decomp, i)), kvec))


def distributed_first_derivatives_tab(decomp, kvec, gtab, glo: float,
                                      gdx: float) -> list:
    """distributed_first_derivatives with a per-mode growth interpolated in
    the table gtab [ntab] over log10 |k| (K8s; the table is copied to each
    shard's device once, as a GrowthTable whose scalars serve every shard
    there): real shards [3, *block]."""
    N = decomp.N
    tabs = {}

    def one(i, k):
        if k.device not in tabs:
            tabs[k.device] = derivatives.GrowthTable(gtab.to(k.device), glo,
                                                     gdx)
        return derivatives.gradient_kspace_tab_shard(
            k, tabs[k.device], glo, gdx, N, *_origin(decomp, i))
    return decomp.inv(decomp.map(one, kvec))


def _origin(decomp, i: int) -> tuple:
    """(y0, z0) of shard i's k window."""
    y0, _, z0, _ = decomp.k_window(i)
    return y0, z0
