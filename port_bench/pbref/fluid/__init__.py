"""Port of sedifoam_tpu/fluid."""
