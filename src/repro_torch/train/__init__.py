"""Training on one device (port of ``repro/train``): the data pipeline,
AdamW, the train step, the fault-tolerant loop, and the node-aware
gradient sync (:mod:`.grad_sync`)."""
from .data import DataConfig, TokenPipeline
from .loop import LoopConfig, train
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .train_step import TrainOptions, build_train_step, make_step_fn

__all__ = ["DataConfig", "TokenPipeline", "LoopConfig", "train",
           "AdamWConfig", "adamw_update", "init_opt_state", "TrainOptions",
           "build_train_step", "make_step_fn"]
