"""Post-processing utilities (port of ``sedifoam_tpu/utils/postprocess.py``;
host side, numpy: tensors come through ``.cpu().numpy()``).

- channel_collapse: the postSediment/channelIndex profile collapse
  (utilities/postSediment/postChannel.C:46-97): average fields over the
  homogeneous directions to produce wall-normal line profiles.
- line_sample: the OpenFOAM `sample` sets analogue used by the Mueller
  validation cases (expMueller06/postprocessing.py).
- TimeAverager: running mean of fields (the UaMean the Mueller cases
  compare against experiment).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from sedifoam_tpu_torch.grid import Grid


def _np(a):
    """A numpy view of a tensor (any device) or array-like."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") \
        else np.asarray(a)


def channel_collapse(field, axis: int = 1):
    """Collapse a (nx,ny,nz) or (3,nx,ny,nz) field to a profile along
    `axis` by averaging over the other two (homogeneous) directions."""
    f = _np(field)
    spatial_axes = tuple(range(f.ndim - 3, f.ndim))
    keep = spatial_axes[axis]
    reduce_axes = tuple(a for a in spatial_axes if a != keep)
    return f.mean(axis=reduce_axes)


def line_sample(field, grid: Grid, start, end, n: int = 100):
    """Sample a field along a straight line (nearest-cell)."""
    f = _np(field)
    pts = np.linspace(np.asarray(start, float), np.asarray(end, float), n)
    ijk = np.stack([
        np.clip(np.searchsorted(grid.axis_faces(a), pts[:, a],
                                side="right") - 1, 0, grid.shape[a] - 1)
        for a in range(3)], axis=-1)
    vals = f[..., ijk[:, 0], ijk[:, 1], ijk[:, 2]]
    return pts, np.moveaxis(vals, -1, 0) if vals.ndim > 1 else vals


class TimeAverager:
    """Running time average of named fields (fieldAverage analogue)."""

    def __init__(self):
        self.n = 0
        self.sums = {}

    def add(self, **fields):
        self.n += 1
        for name, f in fields.items():
            f = _np(f)
            if name in self.sums:
                self.sums[name] = self.sums[name] + f
            else:
                self.sums[name] = f.copy()

    def mean(self, name: str):
        return self.sums[name] / max(self.n, 1)


def find_faces_on_patch(grid: Grid, face_id: int, boxes: Sequence):
    """utilities/findFaceOnPatch analogue (findFaceOnPatch.C:57-86):
    locate boundary faces on one box patch whose centers fall inside any
    of the given (start, end) point pairs.

    face_id: canonical patch face id (0..5 = xm,xp,ym,yp,zm,zp).
    boxes: sequence of (start_xyz, end_xyz) pairs; a face center c is
    selected when (c - start) * (c - end) <= 0 component-wise, exactly
    the reference's sign test (so degenerate boxes select a line/plane
    of faces).

    Returns (ids, centers): ids (n, 2) int in-plane cell indices on the
    patch (ascending-axis order), centers (n, 3) face-center coordinates
    — the structured-mesh equivalent of the reference's global face
    labels written to `faceList`.
    """
    ax = face_id // 2
    oa, ob = (a for a in range(3) if a != ax)
    plane = grid.axis_faces(ax)[0 if face_id % 2 == 0 else -1]
    ca = grid.axis_centers(oa)
    cb = grid.axis_centers(ob)
    A, B = np.meshgrid(ca, cb, indexing="ij")
    centers = np.empty(A.shape + (3,))
    centers[..., ax] = plane
    centers[..., oa] = A
    centers[..., ob] = B
    flat = centers.reshape(-1, 3)
    keep = np.zeros(len(flat), bool)
    for start, end in boxes:
        s = np.asarray(start, float)
        e = np.asarray(end, float)
        keep |= np.all((flat - s) * (flat - e) <= 0.0, axis=1)
    ids = np.argwhere(keep.reshape(A.shape))
    return ids, flat[keep]


def coarsen_faces(faces, step: int):
    """Every `step`-th face with the domain endpoint preserved — plain
    [::step] silently shrinks the domain when (len-1) % step != 0."""
    f = _np(faces)
    out = f[::step]
    if out[-1] != f[-1]:
        out = np.concatenate([out, f[-1:]])
    return out
