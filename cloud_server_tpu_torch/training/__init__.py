"""training of the PyTorch port."""

from cloud_server_tpu_torch.training.checkpoint import (  # noqa: F401
    Checkpointer,
    abstract_train_state,
    restore_or_init,
)
from cloud_server_tpu_torch.training.eval import (  # noqa: F401
    evaluate,
    make_eval_step,
)
from cloud_server_tpu_torch.training.loop import (  # noqa: F401
    LoopConfig,
    train_loop,
)
from cloud_server_tpu_torch.training.optim import make_optimizer  # noqa: F401
from cloud_server_tpu_torch.training.train_step import (  # noqa: F401
    TrainState,
    init_train_state,
    make_train_step,
)
