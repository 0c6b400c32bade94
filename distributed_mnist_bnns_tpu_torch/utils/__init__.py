from .checkpoint import (
    AsyncCheckpointer,
    latest_exists,
    load_checkpoint,
    read_meta,
    save_checkpoint,
)
from .logging_utils import is_primary_host, setup_logging
from .meters import AverageMeter
from .metrics import accuracy
from .profiling import StepTimer, annotate, trace
from .recovery import TrainingFailure, run_with_recovery
from .results import ResultsLog

__all__ = [
    "AsyncCheckpointer",
    "AverageMeter",
    "ResultsLog",
    "StepTimer",
    "TrainingFailure",
    "accuracy",
    "annotate",
    "is_primary_host",
    "latest_exists",
    "load_checkpoint",
    "read_meta",
    "run_with_recovery",
    "save_checkpoint",
    "setup_logging",
    "trace",
]
