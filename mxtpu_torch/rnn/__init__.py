"""mx.rnn namespace of the PyTorch port: the symbolic RNN cells and the
bucketing iterator (``mxtpu``'s ``rnn/rnn.py`` checkpoint helpers are not
ported)."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       ModifierCell, DropoutCell, ZoneoutCell, ResidualCell)
from .io import BucketSentenceIter

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "ModifierCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
           "BucketSentenceIter"]
