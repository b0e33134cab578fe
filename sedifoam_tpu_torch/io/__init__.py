"""Port of sedifoam_tpu/io: the OpenFOAM-ASCII field writer.

The case loader (foamdict, lammps, case, dump) is not ported yet.
"""
