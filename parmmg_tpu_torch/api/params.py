"""Parameter system: the PMMG_Param enum surface + the Info block.

The port's copy of ``parmmg_tpu/api/params.py``.

Mirrors the reference's public parameter API (``PMMG_Param`` IPARAM/DPARAM
enum, ParMmg src/libparmmg.h:54-91) and the ``PMMG_Info`` struct
(libparmmgtypes.h:313-336) with the defaults of ``PMMG_Init_parameters``
(API_functions_pmmg.c:400-426).  Negative sentinels (target mesh size,
metis ratio) mean "use the built-in default and clamp hard", reproduced in
``resolve_target_mesh_size`` (reference grpsplit_pmmg.c:1589-1613).
"""
from __future__ import annotations

import dataclasses
import enum

from ..core import constants as C


class IParam(enum.IntEnum):
    """Integer parameters (libparmmg.h PMMG_IPARAM_*)."""
    verbose = 0
    mmgVerbose = 1
    mem = 2
    debug = 3
    mmgDebug = 4
    angle = 5
    iso = 6
    lag = 7
    optim = 8
    optimLES = 9
    noinsert = 10
    noswap = 11
    nomove = 12
    nosurf = 13
    numberOfLocalParam = 14
    anisosize = 15
    octree = 16
    meshSize = 17           # target per-group mesh size (-mesh-size)
    metisRatio = 18         # ratio distribution groups / remesh groups
    ifcLayers = 19          # interface displacement layers (-nlayers)
    APImode = 20            # faces(0) / nodes(1) distributed input
    globalNum = 21          # compute output global numbering
    niter = 22
    nobalancing = 23
    loadbalancingMode = 24
    repartitioningMode = 25
    nomoveMode = 26
    fem = 27
    opnbdy = 28


class DParam(enum.IntEnum):
    """Double parameters (libparmmg.h PMMG_DPARAM_*)."""
    angleDetection = 100
    hmin = 101
    hmax = 102
    hsiz = 103
    hausd = 104
    hgrad = 105
    hgradreq = 106
    ls = 107
    groupsRatio = 108


@dataclasses.dataclass
class Info:
    """Runtime parameter block (PMMG_Info analogue)."""
    # verbosity / debug
    imprim: int = 1
    mmg_imprim: int = -1
    debug: bool = False
    mmg_debug: bool = False
    # iteration control (defaults: API_functions_pmmg.c:400-426)
    niter: int = C.NITER_DEFAULT
    nobalancing: bool = False
    repartitioning: int = C.REPART_IFC_DISPLACEMENT
    loadbalancing: int = C.LB_METIS
    ifc_layers: int = C.MVIFCS_NLAYERS
    grps_ratio: float = C.GRPS_RATIO
    target_mesh_size: int = C.TARGET_MESH_SIZE_SENTINEL
    metis_ratio: int = C.RATIO_MMG_METIS_SENTINEL
    api_mode: int = C.APIDISTRIB_FACES
    compute_glonum: bool = False
    # remesher switches (forwarded to the wave kernels)
    optim: bool = False
    optimLES: bool = False
    noinsert: bool = False
    noswap: bool = False
    nomove: bool = False
    nosurf: bool = False
    anisosize: bool = False
    opnbdy: bool = False
    # FEM-suitable output by default (MMG5_FEM, API_functions_pmmg.c:413);
    # -nofem turns it off.  Consumed by driver._finish_run's fem pass.
    fem: bool = True
    # unsupported-feature knobs, accepted then rejected at run() like the
    # reference's PMMG_check_inputData (libparmmg.c:69-81): level-set
    # discretization and lagrangian motion are settable but refused
    iso: bool = False
    lag: int = -1
    ls_value: float = 0.0
    mem_budget_mb: int = -1
    # geometry thresholds
    angle_deg: float = C.ANGEDG_DEG
    angle_detection: bool = True
    hmin: float = -1.0      # <0: auto from bounding box
    hmax: float = -1.0
    hsiz: float = -1.0
    hausd: float = C.HAUSD_DEFAULT
    hgrad: float = C.HGRAD_DEFAULT
    hgradreq: float = C.HGRADREQ_DEFAULT
    # local (per-reference) parameters: (elt_type, ref, hmin, hmax, hausd)
    # — the MMG3D_Set_localParameter / parsop surface the reference
    # forwards per group (libparmmg_tools.c:573, API_functions 'nlocal')
    local_params: list = dataclasses.field(default_factory=list)
    # I/O
    fmtout: str = "mesh"
    centralized_output: bool = True
    noout: bool = False
    # resilience (resilience/checkpoint.py): resume the grouped outer
    # loop from the newest PARMMG_CKPT_DIR pass checkpoint (-resume)
    resume: bool = False
    # polish each group after a grouped pass's cycles (-group-polish; the
    # port's switch for the JAX package's grouped_adapt_pass(polish=))
    group_polish: bool = False
    # the shards of a distributed run (-ndev): spread over the ranks of
    # the process group, one visible card a rank, stacked at one process
    n_devices: int = 1

    def angedg(self) -> float:
        """Ridge-detection threshold as a cosine: cos(angle_deg), or the
        'never a ridge' sentinel -1.1 when detection is off (-nr).  The
        single source of truth for initial analysis and mid-adaptation
        re-analysis."""
        import math
        if not self.angle_detection:
            return -1.1
        return math.cos(math.radians(self.angle_deg))

    def set_iparameter(self, key: IParam, val: int) -> None:
        m = {
            IParam.verbose: ("imprim", int),
            IParam.mmgVerbose: ("mmg_imprim", int),
            IParam.mem: ("mem_budget_mb", int),
            IParam.debug: ("debug", bool),
            IParam.mmgDebug: ("mmg_debug", bool),
            IParam.iso: ("iso", bool),
            IParam.lag: ("lag", int),
            IParam.angle: ("angle_detection", bool),
            IParam.optim: ("optim", bool),
            IParam.optimLES: ("optimLES", bool),
            IParam.noinsert: ("noinsert", bool),
            IParam.noswap: ("noswap", bool),
            IParam.nomove: ("nomove", bool),
            IParam.nosurf: ("nosurf", bool),
            IParam.anisosize: ("anisosize", bool),
            IParam.meshSize: ("target_mesh_size", int),
            IParam.metisRatio: ("metis_ratio", int),
            IParam.ifcLayers: ("ifc_layers", int),
            IParam.APImode: ("api_mode", int),
            IParam.globalNum: ("compute_glonum", bool),
            IParam.niter: ("niter", int),
            IParam.nobalancing: ("nobalancing", bool),
            IParam.loadbalancingMode: ("loadbalancing", int),
            IParam.repartitioningMode: ("repartitioning", int),
            IParam.opnbdy: ("opnbdy", bool),
            IParam.fem: ("fem", bool),
        }
        if key not in m:
            raise KeyError(f"unsupported iparam {key}")
        name, cast = m[key]
        setattr(self, name, cast(val))

    def set_dparameter(self, key: DParam, val: float) -> None:
        m = {
            DParam.angleDetection: "angle_deg",
            DParam.hmin: "hmin",
            DParam.hmax: "hmax",
            DParam.hsiz: "hsiz",
            DParam.hausd: "hausd",
            DParam.hgrad: "hgrad",
            DParam.hgradreq: "hgradreq",
            DParam.ls: "ls_value",
            DParam.groupsRatio: "grps_ratio",
        }
        if key not in m:
            raise KeyError(f"unsupported dparam {key}")
        setattr(self, m[key], float(val))


class InputError(ValueError):
    """Unsupported input combination, refused like the reference's
    PMMG_check_inputData (libparmmg.c:55-101)."""


def check_input_data(info: Info, met_is_aniso: bool = False) -> None:
    """Graded input rejection (PMMG_check_inputData, libparmmg.c:69-101):
    lagrangian motion and level-set discretization are unavailable; an
    anisotropic metric is incompatible with -optimLES."""
    if info.lag > -1:
        raise InputError("lagrangian motion option unavailable")
    if info.iso:
        raise InputError("level-set discretization option unavailable")
    if info.optimLES and met_is_aniso:
        raise InputError("-optimLES is not compatible with an anisotropic "
                         "metric")


def resolve_target_mesh_size(info: Info, ne_global: int, n_devices: int)\
        -> int:
    """Group/shard target size with sentinel semantics
    (grpsplit_pmmg.c:1589-1613): negative => default, hard-clamped."""
    t = info.target_mesh_size
    if t < 0:
        t = abs(C.TARGET_MESH_SIZE_SENTINEL)
    return max(C.REDISTR_NELEM_MIN, min(t, max(1, ne_global // n_devices)))
