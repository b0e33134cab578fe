"""Whether a FastDiag axis transform split as the ranks of a fluid split
along grid-x would split it equals the whole grid's call bit for bit,
f32, on one device:

    python3 tests/torch_port_measure_transforms.py [cpu]

(the card unless "cpu" is given; with no card and no "cpu" it raises).
For each grid shape, a field of 1 and of 3 components, and 2 and 4
ranks: "x" is the x transform on blocks of the flattened (y, z)
columns (an all-to-all's layout), "y" and "z" the transforms on the
x-slabs' planes (the tensordot of fastsolve.FastDiag), "y-plane" and
"z-plane" the same as batched per-plane matmuls. Prints one line per
shape and component count, True where every block equals the whole
call's columns bit for bit. The split step's FastDiag solves run on the
gathered whole field instead (fastsolve.py): this script is the record
of why. JAX-free."""
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
from sedifoam_tpu_torch import full_f32_precision  # noqa: E402

SHAPES = [(32, 16, 32), (32, 64, 32), (64, 64, 64), (72, 50, 36),
          (56, 120, 56), (140, 65, 60), (16, 8, 8), (16, 13, 6), (10, 8, 6),
          (32, 32, 32), (64, 16, 64), (32, 16, 16)]


def td(A, b, axis):
    off = b.ndim - 3
    return torch.movedim(torch.tensordot(A, b, dims=([1], [off + axis])),
                         0, off + axis)


def plane_y(A, b):      # per (lead, x) plane: A @ b[..., :, :]
    L, n, ny, nz = b.shape
    b3 = b.reshape(L * n, ny, nz)
    return torch.bmm(A.expand(L * n, ny, ny), b3).reshape(b.shape)


def plane_z(A, b):
    L, n, ny, nz = b.shape
    b3 = b.reshape(L * n, ny, nz)
    return torch.bmm(b3, A.t().expand(L * n, nz, nz)).reshape(b.shape)


def main():
    full_f32_precision()
    dev = torch.device(sys.argv[1] if len(sys.argv) > 1 else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass cpu to run on the CPU")
    print("device:", torch.cuda.get_device_name(0) if dev.type == "cuda"
          else "cpu", flush=True)
    g = torch.Generator().manual_seed(3)
    for shape in SHAPES:
        nx, ny, nz = shape
        mats = [torch.randn(n, n, generator=g).to(dev) for n in shape]
        for L in (1, 3):
            b = torch.randn((L,) + shape, generator=g).to(dev)
            res = {}
            for R in (2, 4):
                if nx % R:
                    continue
                n = nx // R
                # x: on column blocks of the flattened (y, z)
                whole = td(mats[0], b, 0).reshape(L, nx, -1)
                flat = b.reshape(L, nx, -1)
                cols = flat.shape[-1]
                q, r = divmod(cols, R)
                sizes = [q + (1 if i < r else 0) for i in range(R)]
                ok, c0 = True, 0
                for s in sizes:
                    blk = flat[..., c0:c0 + s].contiguous()
                    got = torch.movedim(torch.tensordot(mats[0], blk, dims=([1], [1])), 0, 1)
                    ok &= torch.equal(got, whole[..., c0:c0 + s])
                    c0 += s
                res[f"x R{R}"] = ok
                for a, name, plane in ((1, "y", plane_y), (2, "z", plane_z)):
                    w = td(mats[a], b, a)
                    wp = plane(mats[a], b)
                    ok = okp = True
                    for i in range(R):
                        blk = b[:, i * n:(i + 1) * n].contiguous()
                        ok &= torch.equal(td(mats[a], blk, a), w[:, i * n:(i + 1) * n])
                        okp &= torch.equal(plane(mats[a], blk), wp[:, i * n:(i + 1) * n])
                    res[f"{name} R{R}"] = ok
                    res[f"{name}-plane R{R}"] = okp
            print(shape, "L", L, {k: v for k, v in res.items()}, flush=True)


if __name__ == "__main__":
    main()
