"""The ``ClientModel`` protocol: the surface ``FedAREngine`` trains against.

The engine carries the global model as one flat ``(D,)`` float32 vector
(the aggregation boundary: ``fedavg_agg``, the deviation ban and the
defenses all work on flat deltas) and delegates everything model-shaped to
a ``ClientModel``:

  ``init(generator, device)`` -- one client's params, a tree of tensors
                                 (``core.engine.flatten`` / ``unflatten``
                                 adapt it to the flat boundary).
  ``loss(params, fields)``    -- training loss on client samples.
  ``client_update``           -- Algorithm 2's ClientUpdate: E epochs of
                                 local minibatch SGD for a block of clients
                                 (the client axis is a batch dimension
                                 written out, where the reference vmaps).
  ``metrics``                 -- (eval_loss, eval_accuracy) on a held-out set.
  ``train_flops``             -- per-client FLOP count for the
                                 virtual-latency straggler model.

``fields`` is a dict of the stacked per-client sample tensors keyed by
``data_keys`` (client axis leading).  ``sample_mask`` is the (rows, n)
validity mask over the sample axis, or ``None`` on the dense path.

``supports_fused`` marks a family with a fused local-SGD CUDA kernel, which
``fused_block_update`` launches over a whole client block (and
``fused_ragged_update`` over the packed layout's batch-tile buffer).
``packed_supported`` marks a family that understands the size-bucketed
packed layout (``FederatedDataset.packed_arrays``), whose buckets reuse the
``data_keys`` field names.
"""
from __future__ import annotations


class ClientModel:
    """Base class / protocol for engine-trainable client model families."""

    family: str = "client"
    #: keys of the stacked per-client tensors this model trains on
    data_keys: tuple = ()
    supports_fused: bool = False
    packed_supported: bool = False

    def init(self, generator, device):
        """One client's parameter dict."""
        raise NotImplementedError

    def adopt_template(self, template) -> None:
        """Called by the engine when it was given init params instead of
        calling ``init``; a family that counts its params there reads them
        here."""

    def loss(self, params, fields, sample_mask=None):
        """Training loss over client ``fields``."""
        raise NotImplementedError

    def client_update(self, params, fields, *, lr, batch_size, epochs,
                      sample_mask=None):
        """E epochs of local minibatch SGD from the global ``params`` for
        every client of the block -> dict of stacked (rows, ...) params, or
        the (rows, D) flat rows themselves in ``core.engine.flatten`` order
        (a family whose stacked params would not fit beside them)."""
        raise NotImplementedError

    def metrics(self, params, eval_set):
        """(loss, accuracy) on the held-out ``eval_set``."""
        raise NotImplementedError

    def train_flops(self, sample_shape, *, epochs) -> float:
        """Per-client FLOPs for the virtual-latency model; ``sample_shape``
        is one client's dense sample-block shape (sample axis first)."""
        raise NotImplementedError

    def check_fused(self, batch_size: int) -> None:
        """Raise ``ValueError`` if the fused kernels cannot take this model
        at ``batch_size``; the engine asks once, when it picks the kernel
        route.  Only families with ``supports_fused`` implement it."""
        raise NotImplementedError(
            f"model family {self.family!r} has no fused local-SGD kernel"
        )

    def fused_block_update(self, global_flat, fields, sample_mask, *,
                           lr, batch_size, epochs):
        """Fused-kernel ClientUpdate over a whole client block -> the
        stacked (rows, D) post-SGD flat params, in ``core.engine.flatten``
        order.  Only families with ``supports_fused`` implement it."""
        raise NotImplementedError(
            f"model family {self.family!r} has no fused local-SGD kernel"
        )

    def fused_ragged_update(self, global_flat, tiles, tile_mask, rows, *,
                            lr, epochs):
        """Fused-kernel ClientUpdate over the packed layout's batch-tile
        buffer -> the (R, D) post-SGD flat params of the R clients in
        ``rows``.  Only families with ``supports_fused`` implement it."""
        raise NotImplementedError(
            f"model family {self.family!r} has no fused local-SGD kernel"
        )
