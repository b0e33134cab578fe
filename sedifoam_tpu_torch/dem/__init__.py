"""Port of sedifoam_tpu/dem."""
