"""Runtime services around the coupled step (port of sedifoam_tpu/runtime).

- diagnostics.py — the runtime audits (momentum totals, alpha min/max,
  Courant numbers, average particle velocity) as 0-d tensors
- probes.py     — OpenFOAM probes function-object analogue
- runner.py     — Simulation: time loop, write intervals, timing splits
- checkpoint.py — full-state checkpoint/resume in the JAX package's npz
  format, so a checkpoint crosses packages in both directions
- window.py     — active-window DEM stepping for injection cases
"""
