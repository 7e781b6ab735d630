from spfresh_tpu_torch.utils import metrics
from spfresh_tpu_torch.utils.profiling import PhaseTimer, annotate, device_trace

__all__ = ["PhaseTimer", "annotate", "device_trace", "metrics"]
