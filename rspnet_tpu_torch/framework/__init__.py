"""Experiment framework: args, config bootstrap, logging, checkpoints,
meters, metrics, LR schedules."""
from .arguments import Args, BaseArgs, get_timestamp
from .bootstrap import bootstrap
from .checkpoint import CheckpointManager, load_state, save_state
from .environment import scale_learning_rate, ulimit_n_max
from .logging import set_logging_basic_config
from .meters import AverageMeter, MeterGroup, MetricSpool
from .metrics import accuracy, masked_topk_correct
from .reproduction import initialize_seed

__all__ = [
    "Args", "BaseArgs", "get_timestamp", "bootstrap", "initialize_seed",
    "CheckpointManager", "load_state", "save_state",
    "scale_learning_rate", "ulimit_n_max", "set_logging_basic_config",
    "AverageMeter", "MeterGroup", "MetricSpool", "accuracy",
    "masked_topk_correct",
]
