"""Module layer of the PyTorch port: BaseModule (fit, score, predict),
Module (bind, init_params, init_optimizer, forward, backward, update),
the data-parallel executor group, and the program cache that the
serving engine uses."""
from .base_module import BaseModule
from .module import Module
from .executor_group import DataParallelExecutorGroup
from .fused import ProgramCache

__all__ = ["BaseModule", "Module", "DataParallelExecutorGroup",
           "ProgramCache"]
