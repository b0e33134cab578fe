"""Unified static configuration (frozen dataclasses, hashable).

A field-for-field copy of ``sedifoam_tpu/config.py``: same class names,
field names and defaults (tests/test_torch_slice.py holds the two
against each other). It is copied, not imported, because importing
anything from ``sedifoam_tpu`` imports JAX.

One config tree replaces the reference's two config stacks: the OpenFOAM
dictionaries (constant/{transportProperties,cloudProperties,...},
system/{controlDict,fvSolution,...}) and the LAMMPS input script
(in.lammps + data file).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# DEM
# ---------------------------------------------------------------------------

PAIR_NONE = "none"
PAIR_HOOKE = "hooke"
PAIR_HOOKE_HISTORY = "hooke_history"
PAIR_HERTZ_HISTORY = "hertz_history"  # the reference's gran/hertzFix/history


@dataclasses.dataclass(frozen=True)
class PairParams:
    """Granular contact parameters (pair_style gran/... settings).

    LAMMPS defaulting rules (pair_gran_hertzFix_history.cpp:293-317):
    kt = NULL -> 2/7 kn; gammat = NULL -> 0.5 gamman; dampflag 0 -> gammat=0.
    """

    style: str = PAIR_NONE
    kn: float = 0.0
    kt: Optional[float] = None
    gamman: float = 0.0
    gammat: Optional[float] = None
    xmu: float = 0.0
    dampflag: int = 1

    def resolved(self) -> "PairParams":
        kt = self.kn * 2.0 / 7.0 if self.kt is None else self.kt
        gammat = 0.5 * self.gamman if self.gammat is None else self.gammat
        if self.dampflag == 0:
            gammat = 0.0
        return dataclasses.replace(self, kt=kt, gammat=gammat)


WALL_XPLANE = "xplane"
WALL_YPLANE = "yplane"
WALL_ZPLANE = "zplane"
WALL_ZCYLINDER = "zcylinder"

_WALL_AXIS = {WALL_XPLANE: 0, WALL_YPLANE: 1, WALL_ZPLANE: 2}


@dataclasses.dataclass(frozen=True)
class WallSpec:
    """One fix wall/gran (interfaceToLammps/fix_wall_granFix.cpp)."""

    style: str
    lo: Optional[float] = None   # None == LAMMPS NULL (no wall on that side)
    hi: Optional[float] = None
    cylradius: float = 0.0
    params: PairParams = PairParams()
    # optional wall motion
    wiggle: bool = False
    wiggle_axis: int = 0
    amplitude: float = 0.0
    period: float = 0.0
    vshear: float = 0.0
    shear_axis: int = -1

    @property
    def axis(self) -> int:
        return _WALL_AXIS.get(self.style, 2)


@dataclasses.dataclass(frozen=True)
class DEMConfig:
    dt: float
    pair: PairParams = PairParams()
    walls: Tuple[WallSpec, ...] = ()
    gravity: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # fix fdrag carrier density (0 disables per-substep added mass,
    # fix_fluid_drag.cpp:49-54)
    carrier_rho: float = 0.0
    # cohesion (fix cohesive), None = off
    cohesion: Optional["CohesionParams"] = None
    # pair lubricate/poly (dem/lubrication.py LubricationParams), None = off
    lubrication: Optional[object] = None
    # ---- contact enumeration backend ----
    # 'dense': all-pairs with (N,N,3) history — exact, best below ~10k
    # 'binned': Verlet-skin neighbor tables — scales to large N
    # 'lattice': experimental roll-based bins (dem/lattice.py) —
    #           gather-free, physically anchored. A 'pencil' (y-rank
    #           slot) backend was tried and deleted in round 4: rank
    #           anchoring is unsound on beds with unequal pencil linear
    #           densities (its own W-window audit measured 62k missed
    #           pairs on the 131k jittered bench bed), and its sound
    #           fix degenerates into this lattice; see the STATUS.md
    #           pencil postmortem for the measured cost model
    backend: str = "dense"
    # binned backend: run the contact chain (partner gather, Hertz
    # history, plane walls) through dem/fused.py. On CUDA tensors that is
    # the hand-written kernel (csrc/contact_chain.cu); on CPU tensors its
    # plain PyTorch version. False runs the unfused PyTorch path.
    fused_chain: bool = True
    nbr_k: int = 48              # neighbor slots per particle
    max_per_bin: int = 8         # candidate slots per bin
    cutoff: float = 0.0          # bin pitch: >= max diameter + skin
    skin: float = 0.0            # Verlet skin; rebuild at disp > skin/2
    # K-truncation safety audit radius (the widest interaction ring +
    # skin). When > 0, every rebuild counts in-ring candidates the
    # K-nearest table had to drop and records the worst count in
    # state.nbr_dropped (LAMMPS "dangerous builds" analogue). This is
    # what makes density-sized nbr_k (below the geometric worst-case
    # bound) safe: a nonzero count is a loud correctness signal.
    audit_ring: float = 0.0
    domain_lo: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    domain_hi: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # periodic particle boundaries per axis (LAMMPS `boundary pp ff pp`,
    # lammpsFoam/softParticle.C:186-198 cyclic transforms): positions wrap,
    # contact deltas use minimum image in both backends
    periodic: Tuple[bool, bool, bool] = (False, False, False)
    # particle types held immobile (`fix ... freeze` on a `group ... type T`
    # group, e.g. the frozen bed of transport-bedload/in.lammps): their
    # total force/torque is zeroed after all force fixes, LAMMPS-style
    frozen_types: Tuple[int, ...] = ()
    # physically re-sort the SoA by bin at every rebuild (binned backend).
    # Measured on one v5e chip this is a net ~11% LOSS (TPU row gathers
    # don't reward index locality and the permutation adds rebuild cost),
    # so it is off by default; enable for multi-chip runs, where the
    # bin-sorted order x-slab-aligns the capacity sharding with the grid
    # decomposition and doubles as particle re-bucketing (parallel/mesh).
    sort_on_rebuild: bool = False

    def __post_init__(self):
        # a stale/typo'd backend must fail loudly, not fall through to
        # the dense all-pairs path (an OOM surprise at 100k+ particles)
        if self.backend not in ("dense", "binned", "lattice"):
            raise ValueError(
                f"DEMConfig.backend={self.backend!r}: supported backends "
                "are 'dense', 'binned', 'lattice' (the 'pencil' backend "
                "was deleted in round 4 — see STATUS.md postmortem)")

    def periodic_len(self) -> Tuple[Optional[float], ...]:
        """Domain length per axis for periodic axes, None elsewhere."""
        return tuple(
            (self.domain_hi[a] - self.domain_lo[a]) if self.periodic[a]
            else None for a in range(3))


@dataclasses.dataclass(frozen=True)
class CohesionParams:
    """fix cohesive: van der Waals (interfaceToLammps/fix_cohesive.cpp)."""

    ah: float = 0.0       # Hamaker constant
    lam: float = 0.0      # London retardation wavelength
    smin: float = 0.0     # minimum separation cutoff
    smax: float = 0.0     # maximum separation cutoff
    model: int = 0        # 0 = retarded, 1 = unretarded


# ---------------------------------------------------------------------------
# fluid (PISO two-phase solver)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PISOConfig:
    """system/fvSolution PISO block + pressure solver controls."""

    n_correctors: int = 2
    n_non_orth: int = 0          # trivial on orthogonal grids; kept for parity
    p_ref_cell: int = 0
    p_ref_value: float = 0.0
    p_tol: float = 1e-10
    p_rel_tol: float = 0.0
    p_max_iter: int = 2000
    momentum_relax: float = 1.0  # UbEqn.relax() factor (1 = no relaxation)


@dataclasses.dataclass(frozen=True)
class ChannelForcing:
    """chPressureGrad (lammpsFoam/chPressureGrad/chPressureGrad.C).

    mode: 'none' | 'Ubar' | 'gradPbar' | 'varyingGradP'.
    """

    mode: str = "none"
    flow_direction: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    mag_ubar: float = 0.0        # target bulk velocity (Ubar mode)
    grad_pbar: float = 0.0       # imposed gradient magnitude
    dpdt: float = 0.0            # ramp rate (gradPbar mode)
    period: float = 0.0          # varyingGradP period
    varying_type: str = "sinusoidal"  # 'sinusoidal' | 'square'


@dataclasses.dataclass(frozen=True)
class TurbulenceConfig:
    """lammpsFoamTurbulenceModels: laminar | kEpsilon | Smagorinsky |
    mySmagorinsky (beta-weighted LES variant)."""

    model: str = "laminar"
    # kEpsilon coefficients (standard)
    Cmu: float = 0.09
    C1: float = 1.44
    C2: float = 1.92
    sigma_k: float = 1.0
    sigma_eps: float = 1.3
    # Smagorinsky
    Ck: float = 0.094
    Ce: float = 1.048
    # high-Re wall functions on no-slip patches (OpenFOAM's
    # nutkWallFunction / epsilonWallFunction analogues)
    wall_functions: bool = True
    kappa: float = 0.41
    E_wall: float = 9.8


# ---------------------------------------------------------------------------
# coupling (enhancedCloud / cloudProperties)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CloudConfig:
    """constant/cloudProperties (read at softParticleCloud.C:445-513,
    enhancedCloud.C:573-620, createFields.H:126-159)."""

    drag_model: str = "SyamlalOBrien"
    sub_cycles: int = 1
    sub_steps: int = 1              # DEM substeps per subcycle (adjusted)
    diffusion_band_width: float = 0.006
    diffusion_steps: int = 6
    smooth_direction: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # smoothing flags
    uf_smooth: bool = True
    up_smooth: bool = True
    drag_smooth: bool = True
    alpha_smooth: bool = True
    # per-particle force switches (enhancedCloud.C:586-598)
    particle_drag: bool = True
    particle_pressure_grad: bool = True
    particle_buoyancy: bool = False
    particle_added_mass: bool = False
    particle_lift: bool = False
    particle_history_force: bool = False
    lubrication_force: bool = False
    # inlet forcing region (addParticleOption related)
    inlet_force: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    inlet_box: Tuple[float, ...] = ()   # (xlo,xhi,ylo,yhi,zlo,zhi)
    # particle deletion outside the domain (OpenFOAM wall-patch hits
    # delete particles: softParticle.C:177-184)
    delete_outside: bool = True
    # semi-implicit fluid-side drag (the dormant `semiImplicit` branch of
    # enhancedCloud::calcTcFields, :338-360): Omega = sum(omg) enters the
    # momentum diagonal and Asrc = sum(omg*U_p) the flux. Stabilizes
    # gas-solid beds where the explicit coupling gain dt*omg/(rho_b*beta)
    # exceeds 1 (e.g. expWachem_PCM).
    semi_implicit_drag: bool = False
    # --- particle injection/deletion regions (softParticleCloud.C:445-513,
    # enhancedCloud.C:697-711) ---
    add_particle: int = 0               # addParticle option
    add_interval: float = 1e30          # addParticleTimeStep
    add_box: Tuple[float, ...] = ()     # (x1,x2,y1,y2,z1,z2)
    add_info: Tuple[float, float, int] = (1e-3, 1000.0, 1)  # d, rho, type
    add_velocity: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    random_perturb: float = 0.0
    reduce_number_factor: int = 1
    delete_particle: int = 0            # deleteParticle option
    delete_box: Tuple[float, ...] = ()
    delete_before_add: int = 0
    clear_box: Tuple[float, ...] = ()   # clearInitialBox


@dataclasses.dataclass(frozen=True)
class FluidConfig:
    dt: float
    rhob: float = 1000.0        # carrier density
    nub: float = 1e-6           # carrier kinematic viscosity
    rhoa: float = 2000.0        # particle density (transport dict)
    Cvm: float = 0.0            # virtual-mass coefficient
    Cl: float = 0.0             # lift coefficient
    gravity: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    max_possible_alpha: float = 0.70
    piso: PISOConfig = PISOConfig()
    forcing: ChannelForcing = ChannelForcing()
    turbulence: TurbulenceConfig = TurbulenceConfig()
    # IBM relaxation zone (createIBMForce.H); relax time 0 -> 3*dt
    add_ibm_force: bool = False
    ibm_relax_time: float = 0.0
    # DNS spectral forcing (calcDNSForce.H / UOprocess)
    add_dns_force: bool = False
    dns_alpha: float = 1.0
    dns_sigma: float = 0.1
    dns_k_upper: float = 1e9
    dns_k_lower: float = 0.0
    # accumulation policy for global reductions (audits, forcing means):
    # "compensated" = Neumaier-blocked sums (utils/accum.py; ~f64-quality
    # on the f32 TPU path), "native" = plain jnp.sum (round-2 behavior)
    dtype_policy: str = "compensated"
