"""Optimizers of the port and the int8 gradient compression."""

from .adamw import (AdafactorState, AdamWState, adafactor_init,
                    adafactor_update, adamw_init, adamw_update, lr_schedule,
                    make_optimizer)
from .compression import compress_decompress, init_error_state

__all__ = ["AdamWState", "AdafactorState", "adamw_init", "adamw_update",
           "adafactor_init", "adafactor_update", "lr_schedule",
           "make_optimizer", "compress_decompress", "init_error_state"]
