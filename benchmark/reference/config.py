# The benchmark's frozen copy of pinocchio_tpu_torch/config.py: the reference
# computes with it and never with the program's own module, so that a
# change to the program cannot move the yardstick it is held to.
"""Run configuration for pinocchio-tpu.

Parameter-file-compatible configuration: a reference PINOCCHIO parameter file
(Gadget-style keyword file, see the reference's src/ReadParamfile.c:47-307 and
DOCUMENTATION:258-391) can be loaded unchanged.  Unlike the reference, which
splits configuration between a runtime parameter file and ~25 compile-time -D
directives (src/Makefile:42-86), everything here is a runtime option on one
dataclass.
"""

from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Params:
    # run properties
    RunFlag: str = "run"
    OutputList: str = "outputs"
    BoxSize: float = 128.0          # as given in the parameter file
    BoxInH100: bool = False
    GridSize: int = 64
    RandomSeed: int = 486604
    FixedIC: bool = False
    PairedIC: bool = False

    # cosmology
    Omega0: float = 0.25
    OmegaLambda: float = 0.75
    OmegaBaryon: float = 0.044
    Hubble100: float = 0.70
    Sigma8: float = 0.8
    PrimordialIndex: float = 0.96
    DEw0: float = -1.0
    DEwa: float = 0.0
    TabulatedEoSfile: str = "no"
    FileWithInputSpectrum: str = "no"
    InputSpectrum_UnitLength_in_cm: float = 0.0
    WDM_PartMass_in_kev: float = 0.0

    # memory control
    BoundaryLayerFactor: float = 3.0
    MaxMem: int = 3600
    MaxMemPerParticle: float = 150.0
    PredPeakFactor: float = 0.8

    # output
    CatalogInAscii: bool = False
    OutputInH100: bool = False
    NumFiles: int = 1
    MinHaloMass: int = 10
    AnalyticMassFunction: int = 9
    WriteTimelessSnapshot: bool = False
    DoNotWriteCatalogs: bool = False
    DoNotWriteHistories: bool = False
    DumpProducts: bool = False
    ReadProductsFromDumps: bool = False
    ExitIfExtraParticles: bool = False

    # past light cone
    StartingzForPLC: float = -1.0
    LastzForPLC: float = 0.0
    PLCAperture: float = 30.0
    PLCProvideConeData: bool = False
    PLCCenter: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    PLCAxis: List[float] = field(default_factory=lambda: [1.0, 1.0, 0.0])

    # collapse-time table / CAMB inputs
    CTtableFile: str = "none"
    CAMBMatterFile: str = ""
    CAMBRedshiftsFile: str = ""
    HubbleTableFile: str = "no"

    # compile-time directives of the reference, as runtime switches
    # (reference src/Makefile:42-86)
    two_lpt: bool = True
    three_lpt: bool = True
    plc_enabled: bool = True            # reference: -DPLC
    ell_model: str = "classic"           # classic | sng | tabulated
    scale_dependent: bool = False        # -DSCALE_DEPENDENT
    read_pk_table: bool = False          # -DREAD_PK_TABLE
    recompute_displacements: bool = False
    norad: bool = False                  # -DNORADIATION
    mod_grav_fr: bool = False            # -DMOD_GRAV_FR f(R) gravity
    fr0: float = 1.e-8                   # -DFR0
    use_sim_params: bool = False         # -DUSE_SIM_PARAMS calibration set
    snapshot: bool = False               # -DSNAPSHOT products (zacc, group ID)
    add_rmax_to_snapshot: bool = False   # -DADD_RMAX_TO_SNAPSHOT: RMAX block
                                         # in the timeless snapshot
    light_output: bool = False           # -DLIGHT_OUTPUT: 48-byte binary
                                         # catalog records (no npart/pad),
                                         # auto-detected by ReadPinocchio5
    classic_fragmentation: bool = False  # -DCLASSIC_FRAGMENTATION: ship the
                                         # full boundary layer instead of the
                                         # two-turn needed-particle scheme

    # runtime backend controls (no analog in the reference)
    dtype: str = "float32"              # product float type (fp32 like reference default)
    work_dir: str = "."
    subbox_tasks: int = 1               # fragmentation sub-domains (like NTasks)
    transfer_f16: bool = None           # halve device->host displacement
                                        # transfers (None = auto: on for
                                        # remote TPU backends)
    sparse_transfer: bool = None        # device-side needed-particle
                                        # compaction before the d->h fetch
                                        # (V5 needed-particle maps,
                                        # distribute.c:670-698; None =
                                        # auto: on for TPU backends)
    ooc: str = "auto"                   # out-of-core fmax engine
                                        # (fmax_ooc.py): "auto" = when the
                                        # monolithic device peak exceeds
                                        # HBM (planner), "on", "off"
    ooc_dtype: str = None               # half-transform storage dtype
                                        # (None = bfloat16 on TPU,
                                        # float32 elsewhere/tests)
    ct_interp: str = "trilinear"        # TABULATED_CT lookup variant:
                                        # trilinear | bilinear | bicubic
                                        # (collapse_times.c:1139-1231
                                        # TRILINEAR / BILINEAR_SPLINE /
                                        # ALL_SPLINE compile switch)
    ooc_kz_batch: int = None            # kz planes per ooc build batch
                                        # (None = 16 at N>=256 else Nh;
                                        # a non-divisor of Nh adds one
                                        # remainder batch)
    ooc_group: int = None               # ooc batches fused per dispatch
                                        # via an in-program fori_loop
                                        # (None = 4; 1 = one dispatch
                                        # per batch)
    ooc_z_batch: int = None             # z planes per ooc consumer slab
                                        # (None = 16 at N>=256 else N;
                                        # must divide N)

    # output redshift list (chronological = descending z), read from OutputList
    output_z: List[float] = field(default_factory=lambda: [0.0])

    # ---------------- derived quantities ----------------
    @property
    def BoxSize_htrue(self) -> float:
        return self.BoxSize / self.Hubble100 if self.BoxInH100 else self.BoxSize

    @property
    def BoxSize_h100(self) -> float:
        return self.BoxSize if self.BoxInH100 else self.BoxSize * self.Hubble100

    @property
    def InterPartDist(self) -> float:
        # reference: initialization.c:245
        return self.BoxSize_htrue / self.GridSize

    @property
    def ParticleMass(self) -> float:
        # reference: initialization.c:247 (true Msun)
        return (2.775499745e11 * self.Hubble100 ** 2 * self.Omega0
                * self.InterPartDist ** 3)

    @property
    def k_for_GM(self) -> float:
        # Nyquist wavenumber, reference initialization.c:251
        return math.pi / self.InterPartDist

    @property
    def zlast(self) -> float:
        return self.output_z[-1]

    @property
    def Flast(self) -> float:
        return 1.0 + self.zlast

    @property
    def output_F(self) -> List[float]:
        return [1.0 + z for z in self.output_z]

    @property
    def lpt_order(self) -> int:
        if self.three_lpt:
            return 3
        if self.two_lpt:
            return 2
        return 1

    def validate(self) -> None:
        # CAMB table request implies the neutrino-cosmology feature set of
        # the reference build (src/Makefile:77-80): scale-dependent growth
        # + segmented displacement recomputation
        if self.FileWithInputSpectrum == "CAMBTable":
            self.scale_dependent = True
            self.read_pk_table = True
            self.recompute_displacements = True
        if self.MinHaloMass <= 0:
            self.MinHaloMass = 1
        if self.NumFiles <= 0:
            self.NumFiles = 1
        zs = list(self.output_z)
        if sorted(zs, reverse=True) != zs:
            raise ValueError("output redshifts must be in descending order")
        if self.ell_model not in ("classic", "sng", "tabulated"):
            raise ValueError(f"unknown ell_model {self.ell_model}")
        if self.ct_interp not in ("trilinear", "bilinear", "bicubic"):
            raise ValueError(f"unknown ct_interp {self.ct_interp}")


# typed tag table equivalent to ReadParamfile.c:47-307
_FLOAT_TAGS = {
    "BoxSize", "Omega0", "OmegaLambda", "OmegaBaryon", "Hubble100", "Sigma8",
    "PrimordialIndex", "DEw0", "DEwa", "InputSpectrum_UnitLength_in_cm",
    "WDM_PartMass_in_kev", "BoundaryLayerFactor", "MaxMemPerParticle",
    "PredPeakFactor", "StartingzForPLC", "LastzForPLC", "PLCAperture",
}
_INT_TAGS = {"GridSize", "RandomSeed", "MaxMem", "NumFiles", "MinHaloMass",
             "AnalyticMassFunction"}
_STRING_TAGS = {"RunFlag", "OutputList", "TabulatedEoSfile",
                "FileWithInputSpectrum", "CTtableFile", "CAMBMatterFile",
                "CAMBRedshiftsFile", "HubbleTableFile"}
_LOGICAL_TAGS = {"BoxInH100", "FixedIC", "PairedIC", "CatalogInAscii",
                 "OutputInH100", "WriteTimelessSnapshot", "DoNotWriteCatalogs",
                 "DoNotWriteHistories", "PLCProvideConeData", "DumpProducts",
                 "ReadProductsFromDumps", "ExitIfExtraParticles"}
_VEC3_TAGS = {"PLCCenter", "PLCAxis"}
# tags the reference accepts but we ignore (internal/FFT debugging knobs)
_IGNORED_TAGS = {"UseTransposedFFT", "MimicOldSeed", "DumpSeedPlane",
                 "DumpKDensity", "VerboseLevel", "LargePlane",
                 "Constrain_dim0", "Constrain_dim1", "Constrain_dim2"}


def _strip_comment(line: str) -> str:
    for c in ("%", "#"):
        idx = line.find(c)
        if idx >= 0:
            line = line[:idx]
    return line.strip()


def read_parameter_file(path: str, **overrides) -> Params:
    """Parse a reference-format parameter file into a Params object.

    Mirrors read_parameter_file (ReadParamfile.c:47): 'Tag value' lines,
    comments start with % or #, logical tags are true when present.
    """
    p = Params()
    base = os.path.dirname(os.path.abspath(path))
    with open(path) as fh:
        for raw in fh:
            line = _strip_comment(raw)
            if not line:
                continue
            parts = line.split()
            tag, args = parts[0], parts[1:]
            if tag in _LOGICAL_TAGS:
                setattr(p, tag, True)
            elif tag in _FLOAT_TAGS:
                setattr(p, tag, float(args[0]))
            elif tag in _INT_TAGS:
                setattr(p, tag, int(args[0]))
            elif tag in _STRING_TAGS:
                setattr(p, tag, args[0] if args else "")
            elif tag in _VEC3_TAGS:
                setattr(p, tag, [float(a) for a in args[:3]])
            elif tag in _IGNORED_TAGS:
                pass
            # unknown tags are silently skipped like the reference

    p.work_dir = base
    # output list lives next to the parameter file
    out_path = p.OutputList
    if not os.path.isabs(out_path):
        out_path = os.path.join(base, out_path)
    if os.path.exists(out_path):
        p.output_z = read_outputs(out_path)
    for k, v in overrides.items():
        setattr(p, k, v)
    p.validate()
    return p


def read_outputs(path: str) -> List[float]:
    zs: List[float] = []
    with open(path) as fh:
        for raw in fh:
            line = _strip_comment(raw)
            if not line:
                continue
            for tok in line.split():
                zs.append(float(tok))
    if not zs:
        raise ValueError(f"no output redshifts found in {path}")
    return zs
