"""mx.rnn namespace of the PyTorch port: the symbolic RNN cells, the
bucketing iterator and the RNN checkpoint helpers."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell, GRUCell,
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       ModifierCell, DropoutCell, ZoneoutCell, ResidualCell)
from .io import BucketSentenceIter
from .rnn import save_rnn_checkpoint, load_rnn_checkpoint, do_rnn_checkpoint

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "ModifierCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
           "BucketSentenceIter", "save_rnn_checkpoint",
           "load_rnn_checkpoint", "do_rnn_checkpoint"]
