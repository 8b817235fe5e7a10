from kukeon_tpu_torch.training.train_step import (  # noqa: F401
    TrainState,
    create_moe_train_state,
    create_train_state,
    make_moe_train_step,
    make_train_step,
)
from kukeon_tpu_torch.training.checkpointing import (  # noqa: F401
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from kukeon_tpu_torch.training.data import (  # noqa: F401
    TokenDataset,
    batches,
    sample_batch,
)
