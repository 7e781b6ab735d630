"""Vector file IO (counterpart of ``spfresh_tpu/io/``).  ``write_bvecs``,
which the JAX package lacks, is importable here but not in ``__all__``."""

from spfresh_tpu_torch.io.vecs import (
    read_bvecs,
    read_fvecs,
    read_ivecs,
    write_bvecs,
    write_fvecs,
    write_ivecs,
)

__all__ = ["read_bvecs", "read_fvecs", "read_ivecs", "write_fvecs", "write_ivecs"]
