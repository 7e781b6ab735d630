from spfresh_tpu_torch.core.dtypes import ACCUM_DTYPE, DEFAULT_POLICY, DtypePolicy, as_f32_np

__all__ = ["ACCUM_DTYPE", "DEFAULT_POLICY", "DtypePolicy", "as_f32_np"]
