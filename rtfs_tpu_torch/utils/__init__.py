"""utils of rtfs_tpu_torch (see the package docstring)."""
