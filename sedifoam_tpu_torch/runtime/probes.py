"""Point probes (port of ``sedifoam_tpu/runtime/probes.py``): the OpenFOAM
`probes` function object the reference's validation harness depends on —
e.g. xiaocase1 probes p at two heights and compares the drop against
data/p_bench.dat."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from sedifoam_tpu_torch.grid import Grid


class Probes:
    """Samples cell values at fixed locations (host-side accumulation)."""

    def __init__(self, grid: Grid, locations: Sequence[Tuple[float, ...]]):
        self.grid = grid
        pts = np.asarray(locations, np.float64)
        ijk = np.stack([
            np.clip(np.searchsorted(grid.axis_faces(a), pts[:, a],
                                    side="right") - 1,
                    0, grid.shape[a] - 1)
            for a in range(3)], axis=-1)
        self.cells = (ijk[:, 0] * grid.ny + ijk[:, 1]) * grid.nz + ijk[:, 2]
        self._cells_on = {}          # device -> int64 index tensor
        self.times = []
        self.samples = {}

    def _index(self, device):
        if device not in self._cells_on:
            self._cells_on[device] = torch.as_tensor(
                self.cells, dtype=torch.int64, device=device)
        return self._cells_on[device]

    def sample(self, t: float, **fields):
        """fields: name -> (nx,ny,nz) or (3,nx,ny,nz) tensors of one dtype
        and device: one index_select over all of them and one copy to
        the host."""
        self.times.append(float(t))
        names = list(fields)
        rows = [fields[k].reshape(-1, self.grid.n_cells) for k in names]
        packed = torch.cat(rows, dim=0)
        vals = packed.index_select(1, self._index(packed.device)).cpu()
        vals = vals.numpy()
        o = 0
        for name, f, r in zip(names, (fields[k] for k in names), rows):
            v = vals[o:o + r.shape[0]]
            o += r.shape[0]
            self.samples.setdefault(name, []).append(
                v[0] if f.ndim == 3 else v)

    def series(self, name: str):
        """(times (T,), values (T, [3,] n_probes))."""
        return (np.asarray(self.times),
                np.stack(self.samples[name], axis=0))

    def save(self, path: str) -> None:
        """Persist the accumulated series (the checkpoint sidecar: the
        reference's probe function object appends to its file across
        restarts)."""
        arrays = {f"s_{k}": np.stack(v, axis=0)
                  for k, v in self.samples.items()}
        np.savez_compressed(path, times=np.asarray(self.times, np.float64),
                            **arrays)

    def load(self, path: str) -> None:
        with np.load(path) as d:
            self.times = [float(t) for t in d["times"]]
            self.samples = {k[2:]: [np.asarray(a) for a in d[k]]
                            for k in d.files if k.startswith("s_")}
