"""Vector file IO (counterpart of ``spfresh_tpu/io/``)."""

from spfresh_tpu_torch.io.vecs import (
    read_bvecs,
    read_fvecs,
    read_ivecs,
    write_bvecs,
    write_fvecs,
    write_ivecs,
)

__all__ = ["read_bvecs", "read_fvecs", "read_ivecs", "write_bvecs", "write_fvecs", "write_ivecs"]
