"""The benchmark of fourdgs_tpu_torch (see README.md)."""
