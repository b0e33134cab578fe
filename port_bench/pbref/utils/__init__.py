"""Port of sedifoam_tpu/utils (the compensated reductions)."""
