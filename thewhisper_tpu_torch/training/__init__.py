from thewhisper_tpu_torch.training.train import (  # noqa: F401
    TrainState,
    make_train_step,
    cross_entropy_loss,
    init_train_state,
)
from thewhisper_tpu_torch.training.distill import (  # noqa: F401
    DistillState,
    distill_loss_fn,
    greedy_agreement,
    init_distill_state,
    make_distill_step,
)
