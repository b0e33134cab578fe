"""Port of sedifoam_tpu/coupling."""
