"""OpenFOAM-ASCII field writer (the reference's output format, C12);
port of ``sedifoam_tpu/io/foamwrite.py``, numpy only.

Writes volScalarField/volVectorField files the way OpenFOAM time
directories store them (FoamFile header + `internalField nonuniform
List<...>` in blockMesh cell order: x fastest), so a user of the
reference can point their existing OpenFOAM post-processing (sample,
postChannel, paraFoam readers) at our output unchanged. Fields are
numpy arrays (callers copy tensors to the host); `read_field` reads
one back.
"""

from __future__ import annotations

import os

import numpy as np

from sedifoam_tpu_torch.grid import Grid

_HEADER = """/*--------------------------------*- C++ -*----------------------------------*\\
  Written by sedifoam-tpu (OpenFOAM-compatible ASCII field export)
\\*---------------------------------------------------------------------------*/
FoamFile
{{
    version     2.0;
    format      ascii;
    class       {cls};
    location    "{location}";
    object      {name};
}}
// * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * //

dimensions      {dims};

internalField   nonuniform List<{kind}>
{n}
(
{body}
)
;

boundaryField
{{
{boundary}
}}

// ************************************************************************* //
"""

# dimension sets of the fields the reference AUTO_WRITEs (createFields.H)
_DIMS = {
    "p": "[1 -1 -2 0 0 0 0]",
    "alpha": "[0 0 0 0 0 0 0]",
    "beta": "[0 0 0 0 0 0 0]",
    "k": "[0 2 -2 0 0 0 0]",
    "epsilon": "[0 2 -3 0 0 0 0]",
    "nut": "[0 2 -1 0 0 0 0]",
    "Ua": "[0 1 -1 0 0 0 0]",
    "Ub": "[0 1 -1 0 0 0 0]",
    "U": "[0 1 -1 0 0 0 0]",
    "Asrc": "[1 -2 -2 0 0 0 0]",
}


def _foam_order(arr: np.ndarray) -> np.ndarray:
    """(nx, ny, nz) -> flat in OpenFOAM blockMesh cell order (x fastest:
    cell = i + j*nx + k*nx*ny)."""
    return np.transpose(arr, (2, 1, 0)).reshape(-1)


def write_field(path: str, name: str, field, grid: Grid,
                patch_names=None, time_name: str = "0"):
    """Write a cell field as an OpenFOAM ASCII volScalar/volVectorField.

    field: (nx,ny,nz) scalar or (3,nx,ny,nz) vector array.
    patch_names: names to emit zeroGradient boundary entries for (the
    values live in the internal field; OpenFOAM recomputes patches)."""
    f = np.asarray(field, np.float64)
    if f.ndim == 4:
        cls, kind = "volVectorField", "vector"
        comps = [_foam_order(f[c]) for c in range(3)]
        rows = "\n".join(f"({x:.9g} {y:.9g} {z:.9g})"
                         for x, y, z in zip(*comps))
        n = comps[0].size
    else:
        cls, kind = "volScalarField", "scalar"
        flat = _foam_order(f)
        rows = "\n".join(f"{v:.9g}" for v in flat)
        n = flat.size
    patches = patch_names or ["defaultFaces"]
    boundary = "\n".join(
        f"    {p}\n    {{\n        type            zeroGradient;\n    }}"
        for p in patches)
    text = _HEADER.format(cls=cls, location=time_name, name=name,
                          dims=_DIMS.get(name, "[0 0 0 0 0 0 0]"),
                          kind=kind, n=n, body=rows, boundary=boundary)
    with open(path, "w") as fh:
        fh.write(text)


def write_time_dir(out_dir: str, time_name: str, grid: Grid,
                   patch_names=None, **fields) -> str:
    """Write fields into <out_dir>/<time_name>/ in OpenFOAM layout."""
    tdir = os.path.join(out_dir, time_name)
    os.makedirs(tdir, exist_ok=True)
    for name, arr in fields.items():
        write_field(os.path.join(tdir, name), name, arr, grid,
                    patch_names=patch_names, time_name=time_name)
    return tdir


def read_field(path: str, grid: Grid):
    """Read back a field written by write_field (round-trip check):
    (nx,ny,nz) or (3,nx,ny,nz) numpy array."""
    from sedifoam_tpu_torch.io import foamdict
    d = foamdict.parse_file(path)
    entry = d["internalField"]
    inner = next(e for e in entry if isinstance(e, list))
    arr = np.asarray(inner, float)
    if arr.ndim == 2:   # vector rows
        comps = [arr[:, c].reshape(grid.nz, grid.ny, grid.nx
                                   ).transpose(2, 1, 0) for c in range(3)]
        return np.stack(comps)
    return arr.reshape(grid.nz, grid.ny, grid.nx).transpose(2, 1, 0)
