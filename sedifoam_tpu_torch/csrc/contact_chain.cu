// Binned Hertz/Hooke-history contact chain with static plane walls fused in,
// for NVIDIA Hopper (sm_90a). Built by sedifoam_tpu_torch/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC
// and bound with ctypes through the plain C entry points at the bottom.
//
// Replaces the TPU kernel sedifoam_tpu/dem/fused.py::_kernel (launched by
// chain_forces). Same math as the port's plain PyTorch version,
// sedifoam_tpu_torch/dem/fused.py::contact_chain_reference
// (neighbor.pair_forces_binned + walls.wall_forces), which the tests and
// chip_smoke.py hold it against.
//
// Bound. Counting each input byte once and each output byte once (b = 4
// in f32, 8 in f64), one call moves per particle its own row (11 b + 1:
// pos, vel, omega, radius, mass, active), its index column (4 K), the
// shear written (3 K b) and read where a slot touches (3 b each), the
// wall shear likewise (3 W b, plus 3 b per touching wall), and force and
// torque (6 b). At the bench shape (N = 131072, K = 8, W = 3, f32) that
// is 233-365 B a particle, 30-48 MB a call, 9-14 us at 3.35 TB/s; at the
// channel shape (N = 8192, K = 16, W = 1) 0.8-1.3 us, below the ~1 us
// launch floor. About 150 flops per touching slot: 2-3 us at 67 TFLOP/s.
// So the kernel is bound by memory and by the latency of its gathers,
// and at small N by how many independent loads are in flight.
//
// Design: slot-parallel warps. A block owns 32 consecutive particles
// (one per lane) and has S slot warps: warp s takes slots k = s, s + S,
// ... < K, so up to S of a particle's index -> partner -> history chains
// are in flight at once, and each warp reads the rows nbr_idx[k,
// i0:i0+32] and shear[c, k, i0:i0+32] as 128-byte coalesced rows. The
// block's 32 own rows are read once, coalesced, into shared memory. S is
// 8 (256 threads) while N S chains fit on the card at once, then 4, and 1
// once N alone fills it (slot_warps): at N = 8192 that launches 256
// blocks of 8 warps where one thread a particle launched 32 of 256
// threads, at N = 2048 64 blocks where it launched 8. At the bench shape
// one thread a particle already fills the card, and more warps would only
// queue behind the round tiles (S = 8 measured twice as slow there). With
// S > 1 the next round's index and history loads go out before the
// round's barrier, and a partner's row is read whole at once (fewest round
// trips, for blocks that wait on latency); with S = 1 the next index goes
// out first, and the history and the partner's velocity, spin and mass
// are read only where the slot touches (fewest bytes, for a full card).
//
// Partner rows come straight from the state's arrays. A pack pass that
// first copies every row into a 16-byte-aligned scratch row (three
// 16-byte loads a partner instead of up to 11 scalar ones) was measured
// slower at every shape (PERF.md; tests/torch_port_chain_variants.py
// builds it from this source): the gathers hit L1/L2, and the pass costs
// a launch and a copy.
//
// Reduction: fixed order, no atomics. With S > 1 each slot's force and
// torque term goes to a [S][6][32] shared tile (double-buffered, one
// __syncthreads a round); component c of the sum is added by warp c mod S,
// round by round in k order, so the sum runs over k = 0 .. K-1 exactly as
// a sequential loop would. With S = 1 the lane adds its slots into its
// registers in that order itself. Two runs on one input are equal bit for
// bit (a resumed run equals the straight run; float atomics would not
// give that). The walls (W <= 6) go to warps s, s + S, ... in the last
// round, through their own tile, and are added in wall order after
// tq = -radi * tacc, as the sequential loop does.
//
// What Hopper offers that does not apply: wgmma has no matrix product to
// work on here; TMA moves tiles and cannot gather rows by index; clusters
// share nothing that neighbouring blocks need. Shared memory and
// memory-level parallelism are this kernel's levers.
//
// Layout. Shear history is (3, K, N) and wall shear (3, W, N), N minor;
// both are UPDATED IN PLACE, each element by the one thread that owns its
// (slot, particle). Force and torque are written as (N, 3).
//
// Own rows. A launch computes the rows [row0, row0 + n_rows) of the n
// rows of pos, vel, omega, radius, mass and active (one rank's block of
// a state split over ranks, parallel/mesh.py): own row i is row row0 + i
// there, partners are read there by their index in nbr_idx (n marks an
// empty slot), and nbr_idx (K, n_rows), shear (3, K, n_rows), wall shear
// (3, W, n_rows), force and torque (n_rows, 3) hold the own rows alone.
// A whole launch is row0 = 0, n_rows = n. A row's result reads only its
// own inputs, in a fixed order, so it does not depend on the range.
//
// Numerics. Templated on float and double. Built without FMA contraction
// (--fmad=false) so the f32 rounding follows the plain version op for op.
// Rounding to the nearest integer uses rint (half to even, as torch.round
// and jnp.round). Guards on zero-mass slots use 1e-30, as the TPU kernel
// does; the plain version uses 1e-300 (0 in float). They differ only
// where both masses are 0.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define MAX_WALLS 6
#define TILE 32   // particles per block, one per lane
#define SLOTS 8   // most slot warps a block has (S)
#define ROW 12    // a row: x y z r | vx vy vz m | wx wy wz (one spare)

enum { STYLE_HOOKE = 0, STYLE_HOOKE_HISTORY = 1, STYLE_HERTZ_HISTORY = 2 };

// Every member is 8 bytes wide, so the layout has no padding and matches
// the ctypes.Structure in dem/fused.py (checked at load through
// contact_chain_params_size).
struct LawParams {
  int64_t style;
  double kn, kt, gamman, gammat, xmu;
  double c_damp;   // 2*sqrt(5/6)*beta, beta from gamman (hertz only)
  double kt_safe;  // max(kt, 1e-300)
};

struct WallParams {
  int64_t axis;
  double lo, hi;  // +-1e30 where the wall has no side
  LawParams law;
};

struct ChainParams {
  int64_t n, K, W, shearupdate;
  int64_t row0, n_rows;  // the own rows: [row0, row0 + n_rows) of n
  int64_t periodic[3];
  double plen[3];
  double dt;
  LawParams pair;
  WallParams walls[MAX_WALLS];
};

// Explicit float/double overloads, so each T calls its own precision.
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_rint(float x) { return rintf(x); }
__device__ __forceinline__ double m_rint(double x) { return rint(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
__device__ __forceinline__ float m_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double m_min(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float m_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double m_max(double a, double b) { return fmax(a, b); }

// One touching contact: forcelaws.contact_force. sh holds the pre-update
// shear on entry and the new shear on exit; f gets the force, fs the
// tangential force.
template <typename T>
__device__ __forceinline__ void contact_law(
    const LawParams& p, T dt, bool shearupdate, T overlap, T r, T rinv,
    T rsqinv, const T d[3], T vnnr, const T vtr[3], T sh[3], T meff,
    T poly_arg, T f[3], T fs[3]) {
  const T kn = (T)p.kn, kt = (T)p.kt, xmu = (T)p.xmu;
  if (p.style == STYLE_HOOKE) {
    T damp = meff * (T)p.gamman * vnnr * rsqinv;
    T ccel = kn * overlap * rinv - damp;
    T vrel = m_sqrt(vtr[0] * vtr[0] + vtr[1] * vtr[1] + vtr[2] * vtr[2]);
    T fn = xmu * m_abs(ccel * r);
    T fsm = meff * (T)p.gammat * vrel;
    T ft = vrel != (T)0 ? m_min(fn, fsm) / vrel : (T)0;
    for (int c = 0; c < 3; ++c) {
      fs[c] = -ft * vtr[c];
      f[c] = ccel * d[c] + fs[c];
      sh[c] = (T)0;
    }
    return;
  }
  if (shearupdate)
    for (int c = 0; c < 3; ++c) sh[c] = sh[c] + dt * vtr[c];
  T shrmag = m_sqrt(sh[0] * sh[0] + sh[1] * sh[1] + sh[2] * sh[2]);
  T rsht = (sh[0] * d[0] + sh[1] * d[1] + sh[2] * d[2]) * rsqinv;
  if (shearupdate)
    for (int c = 0; c < 3; ++c) sh[c] = sh[c] - rsht * d[c];

  T ccel, tdamp, kshear, damp_t_coef;
  if (p.style == STYLE_HOOKE_HISTORY) {
    T damp = meff * (T)p.gamman * vnnr * rsqinv;
    ccel = kn * overlap * rinv - damp;
    tdamp = meff * (T)p.gammat;
    kshear = kt;
    damp_t_coef = tdamp / (T)p.kt_safe;
  } else {  // STYLE_HERTZ_HISTORY
    T sqrt_poly = m_sqrt(m_max(poly_arg, (T)0));
    T sn = (T)(2.0 / 1.82 * p.kn) * sqrt_poly;
    T st = (T)(8.0 / 8.84 * p.kn) * sqrt_poly;
    T damp = (T)p.c_damp * vnnr * rsqinv;
    ccel = sqrt_poly * (T)(4.0 / 5.46) * kn * overlap * rinv -
           m_sqrt(sn * meff) * damp;
    tdamp = m_sqrt(st * meff) * (T)p.c_damp;
    kshear = sqrt_poly * (T)(8.0 / 8.84) * kt;
    damp_t_coef = tdamp / (T)8.84 * (T)8.0 / (T)p.kt_safe;
  }
  for (int c = 0; c < 3; ++c) fs[c] = -kshear * sh[c] - tdamp * vtr[c];
  T fsm = m_sqrt(fs[0] * fs[0] + fs[1] * fs[1] + fs[2] * fs[2]);
  T fn = xmu * m_abs(ccel * r);
  if (fsm > fn) {  // Coulomb cap, with the history rescaled to match
    T scale = fn / (fsm == (T)0 ? (T)1 : fsm);
    for (int c = 0; c < 3; ++c) {
      if (shrmag != (T)0) {
        T damp_t = damp_t_coef * vtr[c];
        sh[c] = scale * (sh[c] + damp_t) - damp_t;
        fs[c] = scale * fs[c];
      } else {
        fs[c] = (T)0;
      }
    }
  }
  for (int c = 0; c < 3; ++c) f[c] = ccel * d[c] + fs[c];
}

// Partner j's row (x y z r | vx vy vz m | wx wy wz), values [from, to)
// of it (from is 0 or 4, to is 4 or ROW), from the state's arrays.
template <typename T>
__device__ __forceinline__ void load_partner(
    const T* __restrict__ pos, const T* __restrict__ vel,
    const T* __restrict__ omega, const T* __restrict__ radius,
    const T* __restrict__ mass, int64_t j, int from, int to, T v[ROW]) {
  if (from == 0) {
    for (int c = 0; c < 3; ++c) v[c] = __ldg(pos + 3 * j + c);
    v[3] = __ldg(radius + j);
  }
  if (to == ROW) {
    for (int c = 0; c < 3; ++c) {
      v[4 + c] = __ldg(vel + 3 * j + c);
      v[8 + c] = __ldg(omega + 3 * j + c);
    }
    v[7] = __ldg(mass + j);
  }
}

// Whether a static plane wall touches a particle at xa (its coordinate
// along the wall's axis) of radius radi; da gets the signed distance.
template <typename T>
__device__ __forceinline__ bool wall_touches(const WallParams& wp, T xa,
                                             T radi, bool acti, T& da) {
  const T del1 = xa - (T)wp.lo;
  const T del2 = (T)wp.hi - xa;
  da = del1 < del2 ? del1 : -del2;
  return acti && da * da <= radi * radi && da * da > (T)0;
}

// One touching wall (fix wall/granFix): sh is its history in and out;
// out gets the force and the term the torque loses, as the sequential
// loop forms them. va is the velocity along the wall's axis a.
template <typename T>
__device__ __forceinline__ void wall_contact(const WallParams& wp, T dt,
                                             bool su, int a, T da, T va,
                                             const T vi[3], const T wi[3],
                                             T radi, T mi, T sh[3],
                                             T out[6]) {
  const T wrsq = da * da;
  const T wr = m_sqrt(wrsq), wrinv = (T)1 / wr, wrsqinv = (T)1 / wrsq;
  const T wd[3] = {a == 0 ? da : (T)0, a == 1 ? da : (T)0,
                   a == 2 ? da : (T)0};
  const T wvnnr = va * da;
  T wvt[3], wwr[3], wvtr[3];
  for (int c = 0; c < 3; ++c) {
    wvt[c] = vi[c] - wd[c] * wvnnr * wrsqinv;
    wwr[c] = radi * wi[c] * wrinv;
  }
  wvtr[0] = wvt[0] - (wd[2] * wwr[1] - wd[1] * wwr[2]);
  wvtr[1] = wvt[1] - (wd[0] * wwr[2] - wd[2] * wwr[0]);
  wvtr[2] = wvt[2] - (wd[1] * wwr[0] - wd[0] * wwr[1]);
  const T woverlap = radi - wr;
  T f[3], fs[3];
  contact_law<T>(wp.law, dt, su, woverlap, wr, wrinv, wrsqinv, wd, wvnnr,
                 wvtr, sh, mi, woverlap * radi, f, fs);
  out[0] = f[0];
  out[1] = f[1];
  out[2] = f[2];
  out[3] = radi * (wd[1] * fs[2] - wd[2] * fs[1]) * wrinv;
  out[4] = radi * (wd[2] * fs[0] - wd[0] * fs[2]) * wrinv;
  out[5] = radi * (wd[0] * fs[1] - wd[1] * fs[0]) * wrinv;
}

// Slot k of particle i (own row xi, vi, wi, radi, mi, active acti) with
// partner index j: writes the new history through sh_col (stride K n
// between components) and sets out to (f, (d x fs) / r), as the
// sequential loop forms them. AHEAD: sh holds the slot's history, read
// ahead, and the partner's row is read whole at once (fewest round trips,
// for blocks that wait on latency); else the history, and the partner's
// velocity, spin and mass, are read only where the slot touches (fewest
// bytes, for a full card).
template <typename T, bool AHEAD>
__device__ __forceinline__ void pair_slot(
    const ChainParams& p, T dt, bool su, const T* __restrict__ pos, const T* __restrict__ vel,
    const T* __restrict__ omega, const T* __restrict__ radius,
    const T* __restrict__ mass, const T xi[3], const T vi[3],
    const T wi[3], T radi, T mi, bool acti, int32_t j, T sh[3],
    T* __restrict__ sh_col, int64_t stride, T out[6]) {
  for (int c = 0; c < 6; ++c) out[c] = (T)0;
  bool touch = false;
  T pj[ROW], d[3], rsq = 0;
  if (acti && j >= 0 && j < p.n) {
    load_partner<T>(pos, vel, omega, radius, mass, j, 0, AHEAD ? ROW : 4,
                    pj);
    for (int c = 0; c < 3; ++c) {
      T dc = xi[c] - pj[c];
      if (p.periodic[c]) {
        const T L = (T)p.plen[c];
        dc = dc - L * m_rint(dc / L);
      }
      d[c] = dc;
    }
    rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const T radsum = radi + pj[3];
    touch = rsq < radsum * radsum;
  }
  if (!touch) {
    for (int c = 0; c < 3; ++c) sh_col[c * stride] = (T)0;
    return;
  }
  if (!AHEAD) {
    load_partner<T>(pos, vel, omega, radius, mass, j, 4, ROW, pj);
    for (int c = 0; c < 3; ++c) sh[c] = sh_col[c * stride];
  }
  const T radj = pj[3], mj = pj[7];
  const T radsum = radi + radj;
  const T r = m_sqrt(rsq), rinv = (T)1 / r, rsqinv = (T)1 / rsq;
  T vr[3], wr[3], vtr[3];
  for (int c = 0; c < 3; ++c) {
    vr[c] = vi[c] - pj[4 + c];
    wr[c] = (radi * wi[c] + radj * pj[8 + c]) * rinv;
  }
  const T vnnr = vr[0] * d[0] + vr[1] * d[1] + vr[2] * d[2];
  T vt[3];
  for (int c = 0; c < 3; ++c) vt[c] = vr[c] - d[c] * vnnr * rsqinv;
  vtr[0] = vt[0] - (d[2] * wr[1] - d[1] * wr[2]);
  vtr[1] = vt[1] - (d[0] * wr[2] - d[2] * wr[0]);
  vtr[2] = vt[2] - (d[1] * wr[0] - d[0] * wr[1]);
  const T meff = mi * mj / m_max(mi + mj, (T)1e-30);
  const T overlap = radsum - r;
  const T poly_arg = overlap * radi * radj / m_max(radsum, (T)1e-30);
  T f[3], fs[3];
  contact_law<T>(p.pair, dt, su, overlap, r, rinv, rsqinv, d, vnnr, vtr, sh,
                 meff, poly_arg, f, fs);
  for (int c = 0; c < 3; ++c) sh_col[c * stride] = sh[c];
  out[0] = f[0];
  out[1] = f[1];
  out[2] = f[2];
  out[3] = (d[1] * fs[2] - d[2] * fs[1]) * rinv;
  out[4] = (d[2] * fs[0] - d[0] * fs[2]) * rinv;
  out[5] = (d[0] * fs[1] - d[1] * fs[0]) * rinv;
}

// Wall w of particle i: the test, the history (wsh: read ahead when
// `ahead`, else read here where the wall touches) written back through
// wsh_col, and out = (f, the term the torque loses). xa and va are the
// own position and velocity along the wall's axis.
template <typename T>
__device__ __forceinline__ void wall_slot(
    const WallParams& wp, T dt, bool su, T xa, T va, const T vi[3],
    const T wi[3], T radi, T mi, bool acti, bool ahead, T wsh[3],
    T* __restrict__ wsh_col, int64_t stride, T out[6]) {
  for (int c = 0; c < 6; ++c) out[c] = (T)0;
  T da;
  if (!wall_touches<T>(wp, xa, radi, acti, da)) {
    for (int c = 0; c < 3; ++c) wsh_col[c * stride] = (T)0;
    return;
  }
  if (!ahead)
    for (int c = 0; c < 3; ++c) wsh[c] = wsh_col[c * stride];
  wall_contact<T>(wp, dt, su, (int)wp.axis, da, va, vi, wi, radi, mi, wsh,
                  out);
  for (int c = 0; c < 3; ++c) wsh_col[c * stride] = wsh[c];
}

// Registers: the f32 kernels get 64 a thread (32 warps an SM), the f64
// ones 128 (16 warps).
template <typename T> struct Warps { static constexpr int per_sm = 16; };
template <> struct Warps<float> { static constexpr int per_sm = 32; };

// One block: TILE particles (lane l: particle i0 + l) and S slot warps
// (warp s: slots s, s + S, ... < K). S = 1 adds each slot straight into
// the lane's registers; S > 1 goes through the shared tile of each round.
template <typename T, int S>
__global__ void __launch_bounds__(S * 32, Warps<T>::per_sm / S)
chain_kernel(const __grid_constant__ ChainParams p,
             const T* __restrict__ pos, const T* __restrict__ vel,
             const T* __restrict__ omega, const T* __restrict__ radius,
             const T* __restrict__ mass, const bool* __restrict__ active,
             const int32_t* __restrict__ nbr_idx, T* __restrict__ shear, T* __restrict__ wall_shear,
             T* __restrict__ force, T* __restrict__ torque) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // n: the stride of the own arrays; own row i is row row0 + i of the
  // row arrays (pos ... active)
  const int64_t n = p.n_rows, K = p.K, W = p.W, row0 = p.row0;
  const int64_t i0 = (int64_t)blockIdx.x * TILE, i = i0 + lane;
  const int64_t gi = row0 + i;
  const bool live = i < n;
  const bool su = p.shearupdate != 0;
  const T dt = (T)p.dt;
  // shared memory with S > 1 (chain_smem_bytes<T>(S, W)): the own rows
  // (x y z r vx vy vz m wx wy wz), the per-slot terms of a round
  // double-buffered, the wall terms, the active flags
  extern __shared__ __align__(16) unsigned char smem[];
  T* const own = reinterpret_cast<T*>(smem);
  T* const term = own + ROW * TILE;
  T* const wall = term + 2 * S * 6 * TILE;
  bool* const act = reinterpret_cast<bool*>(wall + W * 6 * TILE);

  // the first slot's index (and with S > 1 its history) loads go out
  // with the own rows
  int64_t k = warp;
  int32_t j = -1;
  T sh[3] = {0, 0, 0};
  if (live && k < K) {
    j = nbr_idx[k * n + i];
    if (S > 1)
      for (int c = 0; c < 3; ++c) sh[c] = shear[(c * K + k) * n + i];
  }
  T xi[3], vi[3], wi[3], radi, mi;
  bool acti;
  if constexpr (S == 1) {  // one warp: each lane reads its own row itself
    for (int c = 0; c < 3; ++c) {
      xi[c] = live ? pos[3 * gi + c] : (T)0;
      vi[c] = live ? vel[3 * gi + c] : (T)0;
      wi[c] = live ? omega[3 * gi + c] : (T)0;
    }
    radi = live ? radius[gi] : (T)0;
    mi = live ? mass[gi] : (T)0;
    acti = live && active[gi];
  } else {  // the block's own rows, read once, coalesced
    for (int e = threadIdx.x; e < 3 * TILE; e += S * 32) {
      const int64_t g = 3 * i0 + e;
      const bool ok = g < 3 * n;
      const int64_t gg = 3 * row0 + g;
      const int l = e / 3, c = e - 3 * l;
      own[c * TILE + l] = ok ? pos[gg] : (T)0;
      own[(4 + c) * TILE + l] = ok ? vel[gg] : (T)0;
      own[(8 + c) * TILE + l] = ok ? omega[gg] : (T)0;
    }
    if (warp == 0) {
      own[3 * TILE + lane] = live ? radius[gi] : (T)0;
      own[7 * TILE + lane] = live ? mass[gi] : (T)0;
      act[lane] = live && active[gi];
    }
    __syncthreads();
    for (int c = 0; c < 3; ++c) {
      xi[c] = own[c * TILE + lane];
      vi[c] = own[(4 + c) * TILE + lane];
      wi[c] = own[(8 + c) * TILE + lane];
    }
    radi = own[3 * TILE + lane];
    mi = own[7 * TILE + lane];
    acti = act[lane];
  }
  // Values along a wall's axis, by selection: a register array indexed at
  // run time would go to local memory.
  auto along = [](const T v[3], int64_t a) {
    return a == 0 ? v[0] : (a == 1 ? v[1] : v[2]);
  };
  auto xa = [&](const WallParams& wp) { return along(xi, wp.axis); };
  auto va = [&](const WallParams& wp) { return along(vi, wp.axis); };

  if constexpr (S == 1) {
    // one slot a round: add it straight into the lane's registers, then
    // the walls in wall order, as the sequential loop does
    T facc[3] = {0, 0, 0}, tacc[3] = {0, 0, 0};
    for (; live && k < K; ++k) {
      const int32_t jk = j;
      if (k + 1 < K) j = nbr_idx[(k + 1) * n + i];  // the next index first
      T out[6];
      pair_slot<T, false>(p, dt, su, pos, vel, omega, radius, mass,
                          xi, vi, wi, radi, mi, acti, jk, sh,
                          shear + k * n + i, K * n, out);
      for (int c = 0; c < 3; ++c) {
        facc[c] += out[c];
        tacc[c] += out[3 + c];
      }
    }
    if (!live) return;
    T tq[3];
    for (int c = 0; c < 3; ++c) tq[c] = -radi * tacc[c];
    for (int64_t w = 0; w < W; ++w) {
      const WallParams& wp = p.walls[w];
      T out[6], wsh[3];
      wall_slot<T>(wp, dt, su, xa(wp), va(wp), vi, wi, radi, mi, acti,
                   false, wsh, wall_shear + w * n + i, W * n, out);
      for (int c = 0; c < 3; ++c) {
        facc[c] += out[c];
        tq[c] -= out[3 + c];
      }
    }
    for (int c = 0; c < 3; ++c) {
      force[3 * i + c] = facc[c];
      torque[3 * i + c] = tq[c];
    }
  } else {
    // Walls: warp s takes walls s, s + S, ... < W in the last round. The
    // test needs only the own row, so the first one's history is read now.
    T wsh0[3] = {0, 0, 0};
    if (live && warp < W) {
      const WallParams& wp = p.walls[warp];
      T da;
      if (wall_touches<T>(wp, xa(wp), radi, acti, da))
        for (int c = 0; c < 3; ++c)
          wsh0[c] = wall_shear[(c * W + warp) * n + i];
    }
    constexpr int Q = (6 + S - 1) / S;  // components a warp adds
    T acc[Q];                             // acc[q]: component warp + q S
    for (int q = 0; q < Q; ++q) acc[q] = (T)0;
    const int64_t rounds = K > 0 ? (K + S - 1) / S : 1;
    for (int64_t rd = 0; rd < rounds; ++rd) {
      T* const tile = term + (rd & 1) * S * 6 * TILE;  // [S][6][TILE]
      if (k < K) {
        T out[6] = {0, 0, 0, 0, 0, 0};
        if (live)
          pair_slot<T, true>(p, dt, su, pos, vel, omega, radius, mass,
                             xi, vi, wi, radi, mi, acti, j, sh,
                             shear + k * n + i, K * n, out);
        for (int c = 0; c < 6; ++c)
          tile[(warp * 6 + c) * TILE + lane] = out[c];
      }
      if (rd == rounds - 1)
        for (int64_t w = warp; w < W; w += S) {
          const WallParams& wp = p.walls[w];
          T out[6] = {0, 0, 0, 0, 0, 0};
          T wsh[3] = {wsh0[0], wsh0[1], wsh0[2]};
          if (live)
            wall_slot<T>(wp, dt, su, xa(wp), va(wp), vi, wi, radi, mi, acti,
                         w == warp, wsh, wall_shear + w * n + i, W * n, out);
          for (int c = 0; c < 6; ++c)
            wall[(w * 6 + c) * TILE + lane] = out[c];
        }
      // the next round's index and history loads go out before the barrier
      k += S;
      if (live && k < K) {
        j = nbr_idx[k * n + i];
        for (int c = 0; c < 3; ++c) sh[c] = shear[(c * K + k) * n + i];
      }
      __syncthreads();
      const int m = (int)(K - rd * S < S ? K - rd * S : S);
      for (int q = 0; q < Q; ++q) {  // this round's slots, in k order
        const int c = warp + q * S;
        if (c < 6)
          for (int s = 0; s < m; ++s)
            acc[q] += tile[(s * 6 + c) * TILE + lane];
      }
    }
    // force = pair sum + the walls in wall order; torque = -radi * (pair
    // sum) - each wall's term: the operations of the sequential loop
    if (!live) return;
    for (int q = 0; q < Q; ++q) {
      const int c = warp + q * S;
      if (c >= 6) break;
      T v = c < 3 ? acc[q] : -radi * acc[q];
      for (int64_t w = 0; w < W; ++w) {
        if (c < 3)
          v += wall[(w * 6 + c) * TILE + lane];
        else
          v -= wall[(w * 6 + c) * TILE + lane];
      }
      if (c < 3)
        force[3 * i + c] = v;
      else
        torque[3 * i + c - 3] = v;
    }
  }
}

// Bytes of shared memory of a block with S slot warps and W walls (none
// with S = 1).
template <typename T>
static size_t chain_smem_bytes(int S, int64_t W) {
  if (S == 1) return 0;
  return (ROW + (2 * S + W) * 6) * TILE * sizeof(T) + TILE * sizeof(bool);
}

// Threads of the chain kernel the card holds at once, read once per
// process from the first card used.
template <typename T>
static int64_t resident_threads() {
  static int64_t resident = 0;
  if (!resident) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    resident = (int64_t)sms * Warps<T>::per_sm * 32;
  }
  return resident;
}

// Slot warps per block for n own rows: 8, else 4, while n S chains fit
// on the card at once; else 1, where one thread a particle keeps the card
// busy and the round tiles would only cost (measured on an H100:
// PERF.md).
template <typename T>
static int slot_warps(int64_t n) {
  const int64_t padded = (n + TILE - 1) / TILE * TILE;
  for (int S = SLOTS; S >= 4; S /= 2)
    if (padded * S <= resident_threads<T>()) return S;
  return 1;
}

template <typename T, int S>
static void launch_chain(const ChainParams* p, const T* pos, const T* vel,
                         const T* omega, const T* radius, const T* mass,
                         const bool* active, const int32_t* nbr_idx,
                         T* shear, T* wall_shear, T* force, T* torque,
                         cudaStream_t s) {
  chain_kernel<T, S><<<(unsigned)((p->n_rows + TILE - 1) / TILE), S * 32,
                       chain_smem_bytes<T>(S, p->W), s>>>(
      *p, pos, vel, omega, radius, mass, active, nbr_idx, shear,
      wall_shear, force, torque);
}

template <typename T>
static int launch(const ChainParams* p, const T* pos, const T* vel,
                  const T* omega, const T* radius, const T* mass,
                  const bool* active, const int32_t* nbr_idx, T* shear,
                  T* wall_shear, T* force, T* torque, void* stream) {
  if (p->n_rows <= 0) return 0;
  if (p->W < 0 || p->W > MAX_WALLS || p->row0 < 0 ||
      p->row0 + p->n_rows > p->n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (slot_warps<T>(p->n_rows)) {
    case 8:
      launch_chain<T, 8>(p, pos, vel, omega, radius, mass, active, nbr_idx,
                         shear, wall_shear, force, torque, s);
      break;
    case 4:
      launch_chain<T, 4>(p, pos, vel, omega, radius, mass, active, nbr_idx,
                         shear, wall_shear, force, torque, s);
      break;
    default:
      launch_chain<T, 1>(p, pos, vel, omega, radius, mass, active, nbr_idx,
                         shear, wall_shear, force, torque, s);
  }
  return (int)cudaGetLastError();
}

// One block of one warp that does nothing: its device time is the launch
// floor that the chain's own time is read against.
__global__ void chain_empty_kernel() {}

extern "C" {

size_t contact_chain_params_size() { return sizeof(ChainParams); }

// The slot warps per block a launch at n particles uses (f64: nonzero
// for double).
int contact_chain_slot_warps(int64_t n, int f64) {
  return f64 ? slot_warps<double>(n) : slot_warps<float>(n);
}

int contact_chain_empty(void* stream) {
  chain_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// Launch the chain on `stream`; no allocation, no synchronisation.
// Returns the cudaError_t of the launch (0 on success).
int contact_chain_f32(const ChainParams* p, const float* pos,
                      const float* vel, const float* omega,
                      const float* radius, const float* mass,
                      const bool* active, const int32_t* nbr_idx,
                      float* shear, float* wall_shear, float* force,
                      float* torque, void* stream) {
  return launch<float>(p, pos, vel, omega, radius, mass, active, nbr_idx,
                       shear, wall_shear, force, torque, stream);
}

int contact_chain_f64(const ChainParams* p, const double* pos,
                      const double* vel, const double* omega,
                      const double* radius, const double* mass,
                      const bool* active, const int32_t* nbr_idx,
                      double* shear, double* wall_shear, double* force,
                      double* torque, void* stream) {
  return launch<double>(p, pos, vel, omega, radius, mass, active, nbr_idx,
                        shear, wall_shear, force, torque, stream);
}

const char* contact_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
