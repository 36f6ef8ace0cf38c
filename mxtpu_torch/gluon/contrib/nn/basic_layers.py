"""Contrib layers of the PyTorch port (``mxtpu``'s
``gluon/contrib/nn/basic_layers.py``)."""
from __future__ import annotations

import torch

from ...block import HybridBlock
from ...nn import Sequential, HybridSequential
from .... import autograd as _ag
from .... import ndarray as nd

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding"]


class Concurrent(Sequential):
    """Children run on the same input, their outputs concatenated along
    ``axis`` (reference basic_layers.py:27)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return nd.concat(*[block(x) for block in self._children.values()],
                         dim=self.axis)


class HybridConcurrent(HybridSequential):
    """Hybridizable Concurrent (reference basic_layers.py:60)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)


class Identity(HybridBlock):
    """The input unchanged (reference basic_layers.py:93)."""

    def hybrid_forward(self, F, x):
        return x


class _SparseGather(torch.autograd.Function):
    """The rows ``ids`` of ``weight``. The backward gives the weight's
    gradient as a sparse COO tensor over the batch's unique ids
    (``torch.unique``, then the output gradient's rows summed a id by
    ``index_add_``): O(batch * dim) memory and work, never O(vocab *
    dim). ``mxtpu`` computes the same rows with ``jnp.unique`` and
    ``segment_sum``."""

    @staticmethod
    def forward(ctx, weight, ids):
        ctx.save_for_backward(ids)
        ctx.weight_shape = weight.shape
        return weight.index_select(0, ids.reshape(-1)).reshape(
            tuple(ids.shape) + tuple(weight.shape[1:]))

    @staticmethod
    def backward(ctx, dy):
        ids, = ctx.saved_tensors
        row = tuple(ctx.weight_shape[1:])
        uniq, inv = torch.unique(ids.reshape(-1), return_inverse=True)
        rows = dy.new_zeros((uniq.numel(),) + row)
        rows.index_add_(0, inv, dy.reshape((-1,) + row))
        return torch.sparse_coo_tensor(uniq.unsqueeze(0), rows,
                                       ctx.weight_shape,
                                       check_invariants=False,
                                       is_coalesced=True), None


class SparseEmbedding(HybridBlock):
    """An embedding whose weight gradient is a compact row-sparse array
    (MXNet's ``contrib.SparseEmbedding``; ``mxtpu``'s, reference
    ``indexing_op.h`` SparseEmbeddingOpBackwardRsp): the forward gathers
    the ids' rows; the backward holds only the batch's unique rows, summed
    (:class:`_SparseGather`), and ``autograd.backward`` writes them into
    the weight's compact gradient array of ``nnz_max`` slots (default
    ``input_dim // 8``, grown when a batch touches more rows). Two calls
    in one recorded graph sum; across backward passes ``grad_req``
    decides (``write`` replaces, ``add`` merges). Pair it with a lazy
    update (SGD, Adam) through ``gluon.Trainer``: only the touched rows
    of the weight and its state change.

    Eager only, like the reference's sparse embedding: ``forward`` is not
    traced by ``hybridize``."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 nnz_max=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = int(input_dim)
        self._output_dim = int(output_dim)
        self._nnz_max = int(nnz_max) if nnz_max else None
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), dtype=dtype,
            grad_stype="row_sparse",
            grad_nnz_max=self._nnz_max or max(1, input_dim // 8))

    def __repr__(self):
        return "SparseEmbedding(%d -> %d)" % (self._input_dim,
                                              self._output_dim)

    def forward(self, x):
        weight = self.weight.data()
        ids = x._data.to(device=weight._data.device, dtype=torch.int64)
        if not _ag.is_recording() or self.weight.grad_req == "null":
            rows = weight._data.detach().index_select(0, ids.reshape(-1))
            return nd.NDArray(rows.reshape(tuple(ids.shape)
                                           + (self._output_dim,)),
                              weight.context)
        with torch.enable_grad():
            out = _SparseGather.apply(weight._data, ids)
        return nd.NDArray(out, weight.context)
