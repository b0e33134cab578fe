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
// Design. One thread per particle i loops over its K neighbor slots. It
// reads nbr_idx[k, i] and loads the partner's position, velocity, angular
// velocity, radius and mass itself, straight from the state's (N, 3) and
// (N,) tensors: the partner gather that the TPU version had to leave
// outside its kernel (as a packed (12, K, N) block) happens here, so no
// packed partner block is ever written to device memory. Then, per slot:
// minimum-image delta, touch test, relative normal/tangential velocity
// with rotation, the contact law (shear-history update and rotation,
// Coulomb cap with history rescale), torque; sums over K stay in
// registers. The plane walls (W <= 6, per-wall shear history) run in the
// same thread afterwards.
//
// Layout. Shear history is (3, K, N) and wall shear (3, W, N), N minor:
// thread i touching shear[c, k, i] is coalesced across a warp. Both are
// UPDATED IN PLACE: each thread reads and writes only its own column i.
// Force and torque are written as (N, 3).
//
// Bound. At the bench shape (N = 131072, K = 8, W = 3) one launch moves
// about 0.7 KB per particle: own row, K partner rows (each ~44 B of
// scattered reads), shear in and out (2 x 96 B), wall shear in and out,
// the (K,) index column and the output, about 95 MB in all, against a few
// hundred flops per slot. It is memory- and gather-bound, not FLOP-bound.
// The simple design answers that by touching each byte once: no packed
// partner copy, no (K, N) intermediates (the plain PyTorch version writes
// and rereads dozens of them), non-contacts exit after the distance test,
// and partner rows come through the read-only cache (const __restrict__),
// where neighbouring particles share many partners.
//
// Numerics. Templated on float and double: a CUDA tensor of either type
// goes through this kernel. Rounding to the nearest integer uses rint
// (half to even, as torch.round and jnp.round), not round. Guards on
// zero-mass slots use 1e-30, as the TPU kernel does; the plain version
// uses 1e-300 (0 in float). They differ only where both masses are 0.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define MAX_WALLS 6

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

template <typename T>
__global__ void __launch_bounds__(256) chain_kernel(
    const ChainParams p, const T* __restrict__ pos, const T* __restrict__ vel,
    const T* __restrict__ omega, const T* __restrict__ radius,
    const T* __restrict__ mass, const bool* __restrict__ active,
    const int32_t* __restrict__ nbr_idx, T* shear, T* wall_shear,
    T* __restrict__ force, T* __restrict__ torque) {
  const int64_t n = p.n;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool su = p.shearupdate != 0;
  const T dt = (T)p.dt;

  T xi[3], vi[3], wi[3];
  for (int c = 0; c < 3; ++c) {
    xi[c] = pos[3 * i + c];
    vi[c] = vel[3 * i + c];
    wi[c] = omega[3 * i + c];
  }
  const T radi = radius[i], mi = mass[i];
  const bool acti = active[i];

  T facc[3] = {0, 0, 0}, tacc[3] = {0, 0, 0};
  for (int64_t k = 0; k < p.K; ++k) {
    const int64_t col = k * n + i;
    const int32_t jraw = nbr_idx[col];
    const bool has = jraw >= 0 && jraw < n;
    const int64_t j = has ? jraw : (jraw < 0 ? 0 : n - 1);
    T d[3];
    for (int c = 0; c < 3; ++c) {
      T dc = xi[c] - pos[3 * j + c];
      if (p.periodic[c]) {
        const T L = (T)p.plen[c];
        dc = dc - L * m_rint(dc / L);
      }
      d[c] = dc;
    }
    const T rsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const T radj = radius[j];
    const T radsum = radi + radj;
    const bool touch = has && acti && rsq < radsum * radsum;
    if (!touch) {
      for (int c = 0; c < 3; ++c) shear[(c * p.K + k) * n + i] = (T)0;
      continue;
    }
    const T r = m_sqrt(rsq), rinv = (T)1 / r, rsqinv = (T)1 / rsq;
    T vr[3], wr[3], vtr[3];
    for (int c = 0; c < 3; ++c) {
      vr[c] = vi[c] - vel[3 * j + c];
      wr[c] = (radi * wi[c] + radj * omega[3 * j + c]) * rinv;
    }
    const T vnnr = vr[0] * d[0] + vr[1] * d[1] + vr[2] * d[2];
    T vt[3];
    for (int c = 0; c < 3; ++c) vt[c] = vr[c] - d[c] * vnnr * rsqinv;
    vtr[0] = vt[0] - (d[2] * wr[1] - d[1] * wr[2]);
    vtr[1] = vt[1] - (d[0] * wr[2] - d[2] * wr[0]);
    vtr[2] = vt[2] - (d[1] * wr[0] - d[0] * wr[1]);
    const T mj = mass[j];
    const T meff = mi * mj / m_max(mi + mj, (T)1e-30);
    const T overlap = radsum - r;
    const T poly_arg = overlap * radi * radj / m_max(radsum, (T)1e-30);
    T sh[3], f[3], fs[3];
    for (int c = 0; c < 3; ++c) sh[c] = shear[(c * p.K + k) * n + i];
    contact_law<T>(p.pair, dt, su, overlap, r, rinv, rsqinv, d, vnnr, vtr,
                   sh, meff, poly_arg, f, fs);
    for (int c = 0; c < 3; ++c) shear[(c * p.K + k) * n + i] = sh[c];
    facc[0] += f[0];
    facc[1] += f[1];
    facc[2] += f[2];
    tacc[0] += (d[1] * fs[2] - d[2] * fs[1]) * rinv;
    tacc[1] += (d[2] * fs[0] - d[0] * fs[2]) * rinv;
    tacc[2] += (d[0] * fs[1] - d[1] * fs[0]) * rinv;
  }
  T tq[3];
  for (int c = 0; c < 3; ++c) tq[c] = -radi * tacc[c];

  // static plane walls (fix wall/granFix), each with its own history
  for (int64_t w = 0; w < p.W; ++w) {
    const WallParams& wp = p.walls[w];
    const int a = (int)wp.axis;
    const T del1 = xi[a] - (T)wp.lo;
    const T del2 = (T)wp.hi - xi[a];
    const T da = del1 < del2 ? del1 : -del2;
    const T wrsq = da * da;
    const bool wtouch = acti && wrsq <= radi * radi && wrsq > (T)0;
    if (!wtouch) {
      for (int c = 0; c < 3; ++c) wall_shear[(c * p.W + w) * n + i] = (T)0;
      continue;
    }
    const T wr = m_sqrt(wrsq), wrinv = (T)1 / wr, wrsqinv = (T)1 / wrsq;
    T wd[3] = {0, 0, 0};
    wd[a] = da;
    const T wvnnr = vi[a] * da;
    T wvt[3], wwr[3], wvtr[3];
    for (int c = 0; c < 3; ++c) {
      wvt[c] = vi[c] - wd[c] * wvnnr * wrsqinv;
      wwr[c] = radi * wi[c] * wrinv;
    }
    wvtr[0] = wvt[0] - (wd[2] * wwr[1] - wd[1] * wwr[2]);
    wvtr[1] = wvt[1] - (wd[0] * wwr[2] - wd[2] * wwr[0]);
    wvtr[2] = wvt[2] - (wd[1] * wwr[0] - wd[0] * wwr[1]);
    const T woverlap = radi - wr;
    T sh[3], f[3], fs[3];
    for (int c = 0; c < 3; ++c) sh[c] = wall_shear[(c * p.W + w) * n + i];
    contact_law<T>(wp.law, dt, su, woverlap, wr, wrinv, wrsqinv, wd, wvnnr,
                   wvtr, sh, mi, woverlap * radi, f, fs);
    for (int c = 0; c < 3; ++c) wall_shear[(c * p.W + w) * n + i] = sh[c];
    for (int c = 0; c < 3; ++c) facc[c] += f[c];
    tq[0] -= radi * (wd[1] * fs[2] - wd[2] * fs[1]) * wrinv;
    tq[1] -= radi * (wd[2] * fs[0] - wd[0] * fs[2]) * wrinv;
    tq[2] -= radi * (wd[0] * fs[1] - wd[1] * fs[0]) * wrinv;
  }
  for (int c = 0; c < 3; ++c) {
    force[3 * i + c] = facc[c];
    torque[3 * i + c] = tq[c];
  }
}

template <typename T>
static int launch(const ChainParams* p, const T* pos, const T* vel,
                  const T* omega, const T* radius, const T* mass,
                  const bool* active, const int32_t* nbr_idx, T* shear,
                  T* wall_shear, T* force, T* torque, void* stream) {
  if (p->n <= 0) return 0;
  if (p->W < 0 || p->W > MAX_WALLS) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t blocks = (p->n + threads - 1) / threads;
  chain_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      *p, pos, vel, omega, radius, mass, active, nbr_idx, shear, wall_shear,
      force, torque);
  return (int)cudaGetLastError();
}

extern "C" {

size_t contact_chain_params_size() { return sizeof(ChainParams); }

// Launch on `stream`; no allocation, no synchronisation. Returns the
// cudaError_t of the launch (0 on success).
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
