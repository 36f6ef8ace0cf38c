"""Gluon of the PyTorch port: the imperative/hybrid high-level API.

Counterpart of ``mxtpu/gluon/``, with ``mxtpu``'s module layout and
public names, reduced to what the port's paths run: Block / HybridBlock
/ SymbolBlock (``hybridize`` as one traced program a signature, captured
in CUDA graphs on the card), Parameter / ParameterDict, Trainer, the
``nn`` layers, the losses (``CTCLoss`` included), the data pipeline,
the model zoo, the ``rnn`` layers and cells, and ``contrib`` (but
``SparseEmbedding``). ``hybridize(remat=True)`` recomputes a block's
body in its backward. Parameters are NDArrays over ``torch.Tensor``s on
one context, ``gpu(0)`` unless the caller names another.
"""
from .parameter import Parameter, Constant, ParameterDict, \
    DeferredInitializationError
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import data
from . import utils
from . import model_zoo
from . import rnn
from . import contrib

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock",
           "SymbolBlock", "Trainer", "nn", "loss", "data", "utils",
           "model_zoo", "rnn", "contrib"]
