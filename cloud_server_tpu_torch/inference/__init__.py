"""inference of the PyTorch port, with the reference's package-level
exports."""

from cloud_server_tpu_torch.inference.sampling import sample_logits  # noqa: F401
from cloud_server_tpu_torch.inference.engine import (  # noqa: F401
    KVCache, encode, generate, init_cache, prefill)
from cloud_server_tpu_torch.inference.beam import beam_search  # noqa: F401
from cloud_server_tpu_torch.inference.server import (  # noqa: F401
    InferenceServer, QueueFullError, Request)
from cloud_server_tpu_torch.inference.router import (  # noqa: F401
    ReplicatedRouter)
from cloud_server_tpu_torch.inference.http_server import (  # noqa: F401
    HttpFrontend)
