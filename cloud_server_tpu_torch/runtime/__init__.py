"""Host-side native runtime: the C++ gathered token reader."""

from cloud_server_tpu_torch.runtime.native import (  # noqa: F401
    NativeTokenDataset,
    load_library,
    native_available,
)
