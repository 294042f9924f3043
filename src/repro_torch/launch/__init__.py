"""Launch layer of the port: input builders (``specs``), the train and
serve step builders (``steps``) and the ADCC trainer (``train``)."""

from .steps import build_serve_step, build_train_step, tree_checksums
from .train import ADCCTrainer, StragglerMonitor, TrainerResult

__all__ = ["build_train_step", "build_serve_step", "tree_checksums",
           "ADCCTrainer", "StragglerMonitor", "TrainerResult"]
