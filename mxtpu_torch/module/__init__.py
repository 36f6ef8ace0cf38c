"""Module layer of the PyTorch port: BaseModule (fit, score, predict),
Module (bind, init_params, init_optimizer, forward, backward, update),
BucketingModule (one Module a bucket over one set of parameters),
SequentialModule (modules chained head to tail), PythonModule and
PythonLossModule (computation in the user's Python), the data-parallel
executor group, and the program cache that the serving engine uses."""
from .base_module import BaseModule
from .module import Module
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
from .executor_group import DataParallelExecutorGroup
from .fused import ProgramCache

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule",
           "DataParallelExecutorGroup", "ProgramCache"]
