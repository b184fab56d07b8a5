"""Training: AdamW, the data stream, gradient compression and the trainer,
ported from ``repro.train`` (the GSPMD sharding helpers excepted, see
:mod:`.trainer`)."""
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state, lr_at
from .data import DataConfig, Prefetcher, TokenStream
from .compression import compress, decompress, ef_compress_tree, init_residual
from .trainer import (
    TrainState,
    TrainerConfig,
    make_train_state,
    make_train_step,
)

__all__ = [
    "AdamWConfig", "OptState", "adamw_update", "init_opt_state", "lr_at",
    "DataConfig", "Prefetcher", "TokenStream",
    "compress", "decompress", "ef_compress_tree", "init_residual",
    "TrainState", "TrainerConfig", "make_train_state", "make_train_step",
]
