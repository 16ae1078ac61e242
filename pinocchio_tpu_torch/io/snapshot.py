"""Gadget-2 format-2 snapshot writers (counterpart of
pinocchio_tpu/io/snapshot.py, one host).

Byte-compatible with the reference's write_snapshot.c and with the JAX
package's files: format-2 blocks (an 8-byte name record [4-char label + the
next record's size + 8] followed by the payload record), a 256-byte HEAD
and a trailing INFO block describing each payload (write_snapshot.c:55-128,
400-506, 999-1024).

Three products, as in the reference:
  - LPT snapshot (special mode 3): ID, POS, VEL, the LPT initial conditions
    at the first output redshift (write_LPT_snapshot,
    write_snapshot.c:138-204)
  - timeless snapshot: ID, [RMAX], FMAX, VEL/VEL2/VL31/VL32, ZACC, GRUP
    (write_timeless_snapshot, write_snapshot.c:207-342)
  - density (special mode 2): ID, DENS (write_density,
    write_snapshot.c:344-397)

The products are the fmax run's host copies (fmax.DenseProducts).  A block
whose payload is a transposed copy is made just before it is written and
dropped after, so that one such copy is alive at a time.
"""

from __future__ import annotations

import os
from typing import Callable, List, Tuple, Union

import numpy as np

from ..config import Params
from ..cosmology import Cosmology

HEADER_DTYPE = np.dtype([
    ("NPart", "<u4", 6), ("Mass", "<f8", 6), ("Time", "<f8"),
    ("RedShift", "<f8"), ("flag_sfr", "<i4"), ("flag_feedback", "<i4"),
    ("NPartTotal", "<u4", 6), ("flag_cooling", "<i4"),
    ("num_files", "<i4"), ("BoxSize", "<f8"), ("Omega0", "<f8"),
    ("OmegaLambda", "<f8"), ("HubbleParam", "<f8"),
    ("flag_stellarage", "<i4"), ("flag_metals", "<i4"),
    ("npartTotalHighWord", "<u4", 6), ("flag_entropy_instead_u", "<i4"),
    ("flag_metalcooling", "<i4"), ("flag_stellarevolution", "<i4"),
    ("fill", "S52")])
assert HEADER_DTYPE.itemsize == 256

INFO_ENTRY = np.dtype([("name", "S4"), ("type", "S8"), ("ndim", "<i4"),
                       ("active", "<i4", 6)])

# a block's payload: an array, or a function that makes it when it is
# written
Payload = Union[np.ndarray, Callable[[], np.ndarray]]


def _write_block_name(fd, label: str, payload_bytes: int):
    # format-2 block marker (WriteBlockName, write_snapshot.c:999-1024)
    np.array([8], "<u4").tofile(fd)
    fd.write(label.encode("ascii")[:4].ljust(4))
    np.array([payload_bytes + 8], "<u4").tofile(fd)
    np.array([8], "<u4").tofile(fd)


def _write_block(fd, label: str, arr: np.ndarray):
    _write_block_name(fd, label, arr.nbytes)
    np.array([arr.nbytes], "<u4").tofile(fd)
    arr.tofile(fd)
    np.array([arr.nbytes], "<u4").tofile(fd)


def _header(params: Params, n: int, z: float) -> np.ndarray:
    h = np.zeros(1, HEADER_DTYPE)
    h["NPart"][0, 1] = n
    h["Mass"][0, 1] = params.ParticleMass * params.Hubble100 * 1e-10
    h["NPartTotal"][0, 1] = n & 0xFFFFFFFF
    h["npartTotalHighWord"][0, 1] = n >> 32
    h["Time"] = 1.0 / (1.0 + z)
    h["RedShift"] = z
    h["num_files"] = 1
    h["BoxSize"] = params.BoxSize_h100
    h["Omega0"] = params.Omega0
    h["OmegaLambda"] = params.OmegaLambda
    h["HubbleParam"] = params.Hubble100
    return h


def _write_snapshot(path, params: Params, z: float,
                    blocks: List[Tuple[str, str, int, Payload]]) -> str:
    """blocks: (label, INFO type string, ndim, payload), the first one the
    particle IDs."""
    n = len(blocks[0][3])
    with open(path, "wb") as fd:
        _write_block(fd, "HEAD", _header(params, n, z))
        info = np.zeros(len(blocks) + 1, INFO_ENTRY)
        info[0] = (b"HEAD", b"HEADER  ", 0, [0, 1, 0, 0, 0, 0])
        for i, (label, typ, ndim, data) in enumerate(blocks):
            _write_block(fd, label, data() if callable(data) else data)
            info[i + 1] = (label.encode().ljust(4), typ.encode().ljust(8),
                           ndim, [0, 1, 0, 0, 0, 0])
        _write_block(fd, "INFO", info)
    return path


def _particle_ids(N: int) -> np.ndarray:
    # LONGIDS is always on: 64-bit IDs, INFO type LLONG
    # (initialize_ID, write_snapshot.c:547-560)
    return np.arange(1, N ** 3 + 1, dtype=np.uint64)


def _rows(stack: np.ndarray) -> Callable[[], np.ndarray]:
    """The [N^3, 3] float32 rows of a [3, N, N, N] stack, made when the
    block is written."""
    return lambda: np.ascontiguousarray(stack.reshape(3, -1).T, np.float32)


def _dense(fmax_result):
    if fmax_result.dense is None:
        raise ValueError("the snapshot needs the whole grid's products: run "
                         "fmax with keep_dense_products (or "
                         "WriteTimelessSnapshot)")
    return fmax_result.dense


def write_lpt_snapshot(params: Params, cosmo: Cosmology, fmax_result,
                       directory=".") -> str:
    """LPT initial conditions at the first output redshift (special mode
    3, pinocchio.c:171-212): positions q + the sum of the displacement
    stacks, q the cell centre, wrapped into the box in Mpc/h; Gadget
    velocities."""
    N = params.GridSize
    z = params.output_z[0]
    vel = {k: v.reshape(3, -1) for k, v in _dense(fmax_result).vel.items()}
    disp = vel["v1"].copy()
    for k in ("v2", "v31", "v32"):
        if k in vel:
            disp += vel[k]

    # mod(q + disp, N) * ipd * h, in place: the same float32 operations
    pos = np.indices((N, N, N), dtype=np.float32).reshape(3, -1) + 0.5
    pos += disp
    np.mod(pos, N, out=pos)
    pos *= np.float32(params.InterPartDist * params.Hubble100)

    # Gadget velocity: peculiar velocity / sqrt(a)
    # (initialize_VEL, write_snapshot.c:977-997)
    vfact = np.float32(cosmo.Hubble(z) / (1.0 + z) * params.InterPartDist
                       * (1.0 + z) * cosmo.fomega(z, params.k_for_GM)
                       / np.sqrt(1.0 + z))

    def velocities():
        v = np.empty((disp.shape[1], 3), np.float32)
        np.multiply(disp.T, vfact, out=v)
        return v

    path = os.path.join(
        directory, f"pinocchio.{z:6.4f}.{params.RunFlag}.LPT_snapshot.out")
    return _write_snapshot(path, params, z, [
        ("ID  ", "LLONG   ", 1, _particle_ids(N)),
        ("POS ", "FLOATN  ", 3,
         lambda: np.ascontiguousarray(pos.T, np.float32)),
        ("VEL ", "FLOATN  ", 3, velocities)])


def write_density_snapshot(params: Params, density: np.ndarray,
                           directory=".") -> str:
    """The linear density field (special mode 2, write_density)."""
    N = params.GridSize
    path = os.path.join(directory, f"pinocchio.{params.RunFlag}.density0.out")
    return _write_snapshot(path, params, params.output_z[-1], [
        ("ID  ", "LLONG   ", 1, _particle_ids(N)),
        ("DENS", "FLOAT   ", 1,
         np.ascontiguousarray(density.ravel(), np.float32))])


def write_timeless_snapshot(params: Params, fmax_result, frag_result,
                            directory=".") -> str:
    """The timeless snapshot: every particle's fmax products, accretion
    redshift and group (write_timeless_snapshot, write_snapshot.c:207-342).

    GRUP holds the group's name (its peak particle's ID) per particle, 0
    outside any group and 1 for a filament (build_groups.c:968-973), as
    64-bit LLONG because LONGIDS is always on.  An RMAX block (the
    smoothing-radius index where Fmax was attained) is added with
    params.add_rmax_to_snapshot (-DADD_RMAX_TO_SNAPSHOT).  A fragmentation
    result without per-particle group names (run without
    WriteTimelessSnapshot) raises ValueError."""
    N = params.GridSize
    if frag_result is None or frag_result.particle_pos is None:
        raise ValueError(
            "timeless snapshot requested but the fragmentation result "
            "carries no per-particle products")
    if frag_result.particle_grup is None:
        raise ValueError(
            "timeless snapshot: particle group names absent (the run was "
            "fragmented without WriteTimelessSnapshot=True)")
    d = _dense(fmax_result)
    # the sweep's zacc and group names back to grid order: particle_pos is
    # the global cell index (one sub-box's, or the multibox merge's over the
    # sub-boxes' well-resolved regions, fragment/subbox._resolved_particles)
    zacc = np.full(N ** 3, -1.0, np.float32)
    grup = np.zeros(N ** 3, np.uint64)
    pos = frag_result.particle_pos
    zacc[pos] = frag_result.particle_zacc
    grup[pos] = frag_result.particle_grup

    blocks = [("ID  ", "LLONG   ", 1, _particle_ids(N))]
    if params.add_rmax_to_snapshot:
        # initialize_RMAX (write_snapshot.c:830-852)
        blocks.append(("RMAX", "LONG    ", 1,
                       np.asarray(d.Rmax, np.int32).ravel()))
    blocks += [("FMAX", "FLOAT   ", 1, np.asarray(d.Fmax, np.float32).ravel()),
               ("VEL ", "FLOATN  ", 3, _rows(d.vel["v1"]))]
    if "v2" in d.vel:
        blocks.append(("VEL2", "FLOATN  ", 3, _rows(d.vel["v2"])))
    if "v31" in d.vel:
        blocks.append(("VL31", "FLOATN  ", 3, _rows(d.vel["v31"])))
        blocks.append(("VL32", "FLOATN  ", 3, _rows(d.vel["v32"])))
    blocks.append(("ZACC", "FLOAT   ", 1, zacc))
    blocks.append(("GRUP", "LLONG   ", 1, grup))
    path = os.path.join(directory,
                        f"pinocchio.{params.RunFlag}.t_snapshot.out")
    return _write_snapshot(path, params, params.zlast, blocks)


def read_snapshot(path: str):
    """Reader of the format-2 snapshots written above (and by the
    reference): (the parsed header, {label: raw payload bytes})."""
    blocks = {}
    with open(path, "rb") as fd:
        while True:
            m = np.fromfile(fd, "<u4", 1)
            if len(m) == 0:
                break
            label = fd.read(4).decode("ascii")
            np.fromfile(fd, "<u4", 2)      # next-size, closing marker
            size = int(np.fromfile(fd, "<u4", 1)[0])
            payload = fd.read(size)
            np.fromfile(fd, "<u4", 1)
            blocks[label] = payload
    header = np.frombuffer(blocks["HEAD"], HEADER_DTYPE)[0] \
        if "HEAD" in blocks else None
    return header, blocks
