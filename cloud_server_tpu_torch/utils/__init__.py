"""utils of the PyTorch port."""

from cloud_server_tpu_torch.utils.tracing import (  # noqa: F401
    StepProfiler,
    annotate,
    capture_trace,
    start_profiler_server,
)
