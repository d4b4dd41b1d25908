"""Training: the port of ``repro.training`` (optimizers, data, checkpoints,
fault tolerance, the train step and the Trainer), over the port's
parameter trees and the plain PyTorch forward."""
from repro_torch.training.optimizer import (AdamW, Lion, make_optimizer,
                                            global_norm)
from repro_torch.training.data import (DataConfig, SyntheticLM, ByteCorpus,
                                       make_dataset)
from repro_torch.training import checkpoint
from repro_torch.training.fault_tolerance import (PreemptionHandler,
                                                  StragglerMonitor)
from repro_torch.training.train_loop import (
    Trainer,
    TrainerConfig,
    make_loss_fn,
    make_train_step,
)

__all__ = [
    "AdamW", "Lion", "make_optimizer", "global_norm",
    "DataConfig", "SyntheticLM", "ByteCorpus", "make_dataset",
    "checkpoint", "PreemptionHandler", "StragglerMonitor",
    "Trainer", "TrainerConfig", "make_loss_fn", "make_train_step",
]
