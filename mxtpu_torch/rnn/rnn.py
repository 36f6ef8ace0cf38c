"""RNN checkpoints of the PyTorch port (``mxtpu/rnn/rnn.py``): a cell's
fused weights are unpacked into per-gate arrays before saving
(``unpack_weights``) and packed again on loading (``pack_weights``), so
one file serves a ``FusedRNNCell`` and the stack of ``LSTMCell`` / ``GRUCell``
it unfuses into, in either package."""
from __future__ import annotations

from .. import model

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _cells(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params,
                        aux_params):
    """``model.save_checkpoint`` with each cell's weights unpacked."""
    args = dict(arg_params)
    for cell in _cells(cells):
        args = cell.unpack_weights(args)
    model.save_checkpoint(prefix, epoch, symbol, args, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint, each cell's
    weights packed for it."""
    sym, arg, aux = model.load_checkpoint(prefix, epoch)
    for cell in _cells(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """An epoch-end callback saving an RNN checkpoint every ``period``
    epochs (file number ``epoch + 1``)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
