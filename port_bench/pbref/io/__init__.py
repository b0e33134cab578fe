"""Case IO (port of sedifoam_tpu/io): populate the config and the
initial state from the reference's own formats, and write results.

- foamdict.py  — tolerant OpenFOAM dictionary parser
- lammps.py    — in.lammps command script + granular data file parser
- case.py      — load_case: a SimConfig + initial state from a case dir
- foamwrite.py — OpenFOAM-ASCII field writer and reader
- dump.py      — LAMMPS-style particle trajectory dumps
"""
