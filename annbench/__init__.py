"""The benchmark of spfresh_tpu_torch (see README.md)."""
