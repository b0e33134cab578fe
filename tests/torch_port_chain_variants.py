#!/usr/bin/env python3
"""Time design variants of the contact-chain kernel on one CUDA card.

    python3 tests/torch_port_chain_variants.py [--parent DIR]

A one-off measurement, not a test: pytest does not collect it and
chip_smoke.py does not run it. It builds variants of the kernel that the
shipped source does not carry, each from a copy of
sedifoam_tpu_torch/csrc/contact_chain.cu with its text edited:

- "pack": a pass first copies every particle's partner row into a
  16-byte-aligned scratch row, and the chain reads a partner with three
  16-byte loads (six in f64) instead of up to 11 scalar ones;
- "S1", "S4", "S8": the slot warps per block forced to 1, 4 or 8 at
  every N, where the shipped kernel chooses them by N (slot_warps);
- "parent": with --parent DIR, the kernel of another checkout (e.g. the
  parent commit unpacked by git archive). Its entry points must take
  the same 13 arguments; its parameter block's size is checked.

Each variant is held against the plain PyTorch version (f32 1e-5, f64
1e-12 of each output's scale), then timed beside the shipped kernel at
chip_smoke.py's kernel shapes and at injection-window sizes between
them, in f32 and f64: device microseconds per launch from torch.profiler
(chip_smoke.device_us: 100 launches on clones of one state), in turns
shipped, variants, variants reversed, shipped, each the mean of its two
turns. Prints a line per shape, then one JSON object. Needs one card;
builds into build/kernels/variants/.
"""

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402

SWITCH = "switch (slot_warps<T>(p->n))"
FORCED = (1, 4, 8)
WINDOWS_F32 = (2048, 4096, 8192, 12288, 16384, 24576, 32768, 49152, 65536)
WINDOWS_F64 = (4096, 8192, 12288, 16384, 24576, 32768, 65536)

# the pack pass and the reads of the packed rows; the rows' address is
# kept in constant memory, set where the scratch grows
PACK = r"""
__constant__ void* chain_rows;
static void* pack_buf = nullptr;
static size_t pack_cap = 0;

__device__ __forceinline__ void put16(float* r, const float* v) {
  *reinterpret_cast<float4*>(r) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void put16(double* r, const double* v) {
  *reinterpret_cast<double2*>(r) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void get16(const float* r, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(r));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void get16(const double* r, double* v) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(r));
  v[0] = a.x; v[1] = a.y;
}

template <typename T>
__global__ void __launch_bounds__(256) chain_pack_kernel(
    int64_t n, const T* __restrict__ pos, const T* __restrict__ vel,
    const T* __restrict__ omega, const T* __restrict__ radius,
    const T* __restrict__ mass, T* __restrict__ rows) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T v[ROW] = {pos[3 * i],   pos[3 * i + 1],   pos[3 * i + 2],
                    radius[i],    vel[3 * i],       vel[3 * i + 1],
                    vel[3 * i + 2], mass[i],        omega[3 * i],
                    omega[3 * i + 1], omega[3 * i + 2], (T)0};
  constexpr int per = 16 / sizeof(T);
  for (int q = 0; q < ROW; q += per) put16(rows + ROW * i + q, v + q);
}

template <typename T>
__device__ __forceinline__ void load_partner(
    const T* __restrict__ pos, const T* __restrict__ vel,
    const T* __restrict__ omega, const T* __restrict__ radius,
    const T* __restrict__ mass, int64_t j, int from, int to, T v[ROW]) {
  const T* rows = static_cast<const T*>(chain_rows);
  constexpr int per = 16 / sizeof(T);
  for (int q = from; q < to; q += per) get16(rows + ROW * j + q, v + q);
}
"""

PACK_LAUNCH = r"""{
    const size_t need = (size_t)p->n * ROW * sizeof(T);
    if (need > pack_cap) {
      cudaFree(pack_buf);
      if (cudaMalloc(&pack_buf, need)) return (int)cudaGetLastError();
      pack_cap = need;
      cudaMemcpyToSymbol(chain_rows, &pack_buf, sizeof(pack_buf));
    }
    chain_pack_kernel<T><<<(unsigned)((p->n + 255) / 256), 256, 0, s>>>(
        p->n, pos, vel, omega, radius, mass, static_cast<T*>(pack_buf));
  }
  """


def variant_sources(src):
    """{name: source text} of the variants built from the shipped
    source `src`."""
    head = "template <typename T>\n__device__ __forceinline__ void " \
        "load_partner("
    i = src.index(head)
    j = src.index("\n}\n", i) + 3
    if src.count(SWITCH) != 1:
        raise SystemExit(f"{SWITCH!r} not found once in the source")
    pack = src[:i] + PACK + src[j:]
    pack = pack.replace(SWITCH, PACK_LAUNCH + SWITCH)
    out = {"pack": pack}
    for S in FORCED:
        out[f"S{S}"] = src.replace(SWITCH, f"switch ({S})")
    return out


def build_all(parent):
    """Build the variants (and the parent's kernel), one nvcc each,
    started together; returns {name: ctypes library}."""
    from sedifoam_tpu_torch import _build
    from sedifoam_tpu_torch.dem import fused
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "contact_chain.cu").read_text()
    files = {}
    for name, text in variant_sources(src).items():
        files[name] = out_dir / f"{name}.cu"
        files[name].write_text(text)
    if parent:
        files["parent"] = os.path.join(parent, "sedifoam_tpu_torch", "csrc",
                                       "contact_chain.cu")
    procs = {name: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
         str(out_dir / f"lib{name}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, path in files.items()}
    libs = {"shipped": fused._library()}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "registers" in ln]
        print(f"built {name}: {'; '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        lib.contact_chain_params_size.restype = ctypes.c_size_t
        if lib.contact_chain_params_size() != ctypes.sizeof(fused._Chain):
            raise SystemExit(f"{name}: another parameter block layout")
        for fn in (lib.contact_chain_f32, lib.contact_chain_f64):
            fn.argtypes = [ctypes.c_void_p] * 13
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(lib, p, dem, reps):
    """launch(r): lib's kernel on the r-th of `reps` clones of p's
    contact history; returns (force, torque, shear, wall_shear)."""
    import torch
    from sedifoam_tpu_torch.dem import fused
    walls = dem.walls if fused.walls_fusible(dem.walls) else ()
    fused.check_inputs(p, p.nbr_idx, len(walls))
    plen = dem.periodic_len()
    cp = fused._chain_params(p.n_capacity, p.nbr_idx.shape[0], float(dem.dt),
                             True, None if plen is None else tuple(plen),
                             dem.pair, tuple(walls))
    fn = lib.contact_chain_f32 if p.pos.dtype == torch.float32 \
        else lib.contact_chain_f64
    clones = [p._replace(shear=p.shear.clone(),
                         wall_shear=p.wall_shear.clone())
              for _ in range(reps)]

    def launch(r):
        q = clones[r]
        force, torque = torch.empty_like(q.pos), torch.empty_like(q.pos)
        err = fn(ctypes.addressof(cp), *(t.data_ptr() for t in (
            q.pos, q.vel, q.omega, q.radius, q.mass, q.active, q.nbr_idx,
            q.shear)), q.wall_shear.data_ptr() if walls else None,
            force.data_ptr(), torque.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch error {err}")
        return force, torque, q.shear, q.wall_shear if walls else None
    return launch


def check(name, lib, p, dem):
    """lib's kernel against the plain version on a clone of p."""
    import torch
    from sedifoam_tpu_torch.dem import fused
    walls = dem.walls if fused.walls_fusible(dem.walls) else ()
    ref = fused.contact_chain_reference(
        smoke.tree_map(torch.clone, p), dem.pair, dem.dt, p.nbr_idx, True,
        dem.periodic_len(), walls)
    got = launcher(lib, p, dem, 1)(0)
    torch.cuda.synchronize()
    tol = 1e-12 if p.pos.dtype == torch.float64 else 1e-5
    worst = max(smoke.rel_err(a, b) for a, b in zip(ref, got)
                if a is not None)
    if worst > tol:
        raise SystemExit(f"{name} disagrees with the plain chain "
                         f"({worst:.3e})")


def shapes(dev):
    """(label, state, DEMConfig) at chip_smoke.py's kernel shapes and the
    window sizes, the windows filled with the bench lattice's first N
    particles."""
    from sedifoam_tpu_torch.runtime.window import window_slice
    cfg, p = smoke.kernel_case(dev)
    p64 = smoke.tree_map(
        lambda t: t.double() if t.is_floating_point() else t, p)
    ccfg, cp = smoke.channel_kernel_case(dev)
    out = [("bench f32", p, cfg.dem), ("bench f64", p64, cfg.dem),
           ("channel f32", cp, ccfg.dem)]
    out += [(f"window {n} f32", window_slice(p, n), cfg.dem)
            for n in WINDOWS_F32]
    out += [(f"window {n} f64", window_slice(p64, n), cfg.dem)
            for n in WINDOWS_F64]
    return out


def main():
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="also time the kernel of the checkout in DIR")
    args = ap.parse_args()
    smi = smoke.phase_environment()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from sedifoam_tpu_torch import full_f32_precision
    from sedifoam_tpu_torch.dem import fused
    full_f32_precision()
    libs = build_all(args.parent)
    names = [n for n in libs if n != "shipped"]
    rows = []
    floor = smoke.floor_us()
    print(f"empty kernel (launch floor): {floor:.3f} us", flush=True)
    for label, p, dem in shapes(dev):
        for name in names:
            check(f"{name} [{label}]", libs[name], p, dem)
        order = ["shipped", *names, *reversed(names), "shipped"]
        times = {}
        for name in order:
            us = smoke.device_us(launcher(libs[name], p, dem,
                                          smoke.PROFILE_REPS))[0]
            times.setdefault(name, []).append(us)
        mean = {n: sum(t) / len(t) for n, t in times.items()}
        S = fused._library().contact_chain_slot_warps(
            p.n_capacity, int(p.pos.dtype == torch.float64))
        fastest = min(("S1", "S4", "S8"), key=mean.get)
        rows.append({"shape": label, "N": p.n_capacity,
                     "K": p.nbr_idx.shape[0], "slot_warps": S,
                     "fastest_forced": fastest, "us": mean,
                     "turns_us": times})
        print(f"[{label}] N={p.n_capacity} K={p.nbr_idx.shape[0]}, shipped "
              f"picks S={S}, fastest forced {fastest}: " + ", ".join(
                  f"{n} {mean[n]:.3f}" for n in ["shipped", *names])
              + " us (device, profiler, mean of 2 turns; the turns of "
              "the shipped kernel " + " and ".join(
                  f"{t:.3f}" for t in times["shipped"]) + ")", flush=True)
    print(smi)
    print(json.dumps({"floor_us": floor, "shapes": rows}))


if __name__ == "__main__":
    main()
