"""The benchmark of rspnet_tpu_torch (see README.md)."""
