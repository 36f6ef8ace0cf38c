"""mx.rnn namespace of the PyTorch port: the fused symbolic RNN cell."""
from .rnn_cell import RNNParams, BaseRNNCell, FusedRNNCell

__all__ = ["RNNParams", "BaseRNNCell", "FusedRNNCell"]
