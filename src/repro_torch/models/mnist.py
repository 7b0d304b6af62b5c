"""The paper's client model: a small MLP digit classifier (§IV).

28x28 images flattened to 784-vectors, local SGD on the cross-entropy, and
a per-robot hidden activation, Softmax or ReLU (Table II).  Params are a
dict of tensors; functions take either one model (x (n, I)) or a block of
per-client models with a leading client axis (x (R, n, I), activation (R,)).
"""
from __future__ import annotations

import torch

from repro_torch.configs.fedar_mnist import MnistConfig
from repro_torch.kernels.local_sgd import local_sgd as local_sgd_kernel
from repro_torch.kernels.local_sgd import kernel_attrs, local_sgd_ragged
from repro_torch.models.client import ClientModel


def init_mnist(generator: torch.Generator, cfg: MnistConfig, device="cpu"):
    """He-scaled normal init drawn from ``generator`` (a CPU generator, so
    the values do not depend on the device)."""
    s1 = (2.0 / cfg.input_dim) ** 0.5
    s2 = (2.0 / cfg.hidden) ** 0.5
    w1 = torch.randn(cfg.input_dim, cfg.hidden, generator=generator) * s1
    w2 = torch.randn(cfg.hidden, cfg.num_classes, generator=generator) * s2
    return {
        "w1": w1.to(device),
        "b1": torch.zeros(cfg.hidden, device=device),
        "w2": w2.to(device),
        "b2": torch.zeros(cfg.num_classes, device=device),
    }


def _act(activation, like: torch.Tensor) -> torch.Tensor:
    a = torch.as_tensor(activation, device=like.device)
    return a.reshape(*a.shape, 1, 1)


def mnist_logits(params, x, activation=0):
    """activation: 0 = ReLU, 1 = Softmax (Table II assigns one per robot);
    a scalar, or (R,) for a block of clients."""
    h = x @ params["w1"] + params["b1"].unsqueeze(-2)
    soft = _act(activation, h) == 1
    h = torch.where(soft, torch.softmax(h, -1), torch.relu(h))
    return h @ params["w2"] + params["b2"].unsqueeze(-2)


def mnist_loss(params, x, y, activation=0, sample_mask=None):
    """Cross-entropy over the sample axis; ``sample_mask`` excludes padded
    samples (the mean renormalizes over the real samples, and a fully
    padded batch contributes zero loss and zero gradient)."""
    lg = mnist_logits(params, x, activation)
    lse = torch.logsumexp(lg, -1)
    gold = torch.gather(lg, -1, y.long().unsqueeze(-1)).squeeze(-1)
    per_sample = lse - gold
    if sample_mask is None:
        return per_sample.mean(-1)
    m = sample_mask.to(per_sample.dtype)
    return (per_sample * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)


def mnist_accuracy(params, x, y, activation=0):
    pred = torch.argmax(mnist_logits(params, x, activation), -1)
    return (pred == y).to(torch.float32).mean(-1)


def local_sgd(params, x, y, *, lr: float, batch_size: int, epochs: int,
              activation=0, sample_mask=None):
    """ClientUpdate (Algorithm 2 lines 16-21) for a block of clients, by
    autograd: from the global ``params``, every client runs E epochs of
    batch SGD on its own x (R, n, I), y (R, n).  Returns the dict of
    stacked (R, ...) post-SGD params.

    With ``sample_mask`` None (the dense path) the batch count is FLOORED
    (``n // B``), as the reference's dense path does; with a (R, n) mask it
    is rounded UP and the tail padded with mask-False samples, so trailing
    real samples still train.  The two agree when ``n % B == 0``."""
    R, n = x.shape[:2]
    B = batch_size
    if sample_mask is None:
        nb = n // B
        xb = x[:, :nb * B].reshape(R, nb, B, -1)
        yb = y[:, :nb * B].reshape(R, nb, B)
        mb = None
    else:
        nb = -(-n // B)
        pad = nb * B - n
        xb = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(R, nb, B, -1)
        yb = torch.nn.functional.pad(y, (0, pad)).reshape(R, nb, B)
        mb = torch.nn.functional.pad(sample_mask.to(torch.bool), (0, pad))
        mb = mb.reshape(R, nb, B)
    keys = sorted(params)
    p = {k: params[k].expand(R, *params[k].shape).clone() for k in keys}
    with torch.enable_grad():
        for _ in range(epochs):
            for b in range(nb):
                leaves = {k: p[k].detach().requires_grad_(True) for k in keys}
                loss = mnist_loss(leaves, xb[:, b], yb[:, b], activation,
                                  None if mb is None else mb[:, b])
                grads = torch.autograd.grad(loss.sum(), [leaves[k] for k in keys])
                p = {k: leaves[k].detach() - lr * g for k, g in zip(keys, grads)}
    return p


class MnistClientModel(ClientModel):
    """The paper's Table-II MLP behind the engine's ``ClientModel`` surface.

    Data fields: ``x`` (R, n, 784) flattened images, ``y`` (R, n) labels,
    ``activations`` (R,) per-robot hidden activation id (0=ReLU,
    1=Softmax).  Ships the fused local-SGD CUDA kernel, dense and ragged,
    and takes the packed layout.
    """

    family = "mnist_mlp"
    data_keys = ("x", "y", "activations")
    supports_fused = True
    packed_supported = True

    def __init__(self, cfg: MnistConfig | None = None):
        self.cfg = cfg if cfg is not None else MnistConfig()

    def init(self, generator, device):
        return init_mnist(generator, self.cfg, device)

    def loss(self, params, fields, sample_mask=None):
        return mnist_loss(params, fields["x"], fields["y"],
                          fields["activations"], sample_mask)

    def client_update(self, params, fields, *, lr, batch_size, epochs,
                      sample_mask=None):
        return local_sgd(
            params, fields["x"], fields["y"], lr=lr, batch_size=batch_size,
            epochs=epochs, activation=fields["activations"],
            sample_mask=sample_mask,
        )

    def metrics(self, params, eval_set):
        x, y = eval_set
        return mnist_loss(params, x, y), mnist_accuracy(params, x, y)

    def train_flops(self, sample_shape, *, epochs) -> float:
        # 2 * E * n * forward matmul flops, the paper's latency model
        return float(
            2 * epochs * sample_shape[0] * self.cfg.input_dim * self.cfg.hidden
        )

    def check_fused(self, batch_size: int) -> None:
        """Raises unless the fused kernel takes this shape and at least one
        of its clusters fits the card."""
        kernel_attrs(self.cfg.input_dim, self.cfg.hidden, self.cfg.num_classes,
                     batch_size)

    def fused_block_update(self, global_flat, fields, sample_mask, *,
                           lr, batch_size, epochs):
        """One launch of the fused kernel runs every client's whole masked
        epochs x batches loop, reading the global row in the flat order
        ``b1, b2, w1, w2`` (``kernels.ref.split_flat``).  The dense path
        passes an all-ones mask, so the batch count is rounded up (equal to
        the dense floor when ``n % B == 0``)."""
        x = fields["x"]
        m = (torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
             if sample_mask is None else sample_mask)
        return local_sgd_kernel(
            global_flat, x, fields["y"], fields["activations"], m,
            hidden=self.cfg.hidden, classes=self.cfg.num_classes, lr=lr,
            batch_size=batch_size, epochs=epochs,
        )

    def fused_ragged_update(self, global_flat, tiles, tile_mask, rows, *,
                            lr, epochs):
        """One launch of the ragged kernel runs the whole packed layout (or
        a gated cohort of it): ``tiles`` holds the batch-tile buffer
        ``x`` (T, B, I) / ``y`` (T, B), ``tile_mask`` (T, B) is this round's
        validity, and ``rows`` = (act, nb, off), each (R,) int32, names the
        R clients to train: client r walks its own ``nb[r]`` tiles from
        ``off[r]``.  Returns the (R, D) post-SGD flat rows in ``rows``
        order."""
        act, nb, off = rows
        return local_sgd_ragged(
            global_flat, tiles["x"], tiles["y"], tile_mask, act, nb, off,
            hidden=self.cfg.hidden, classes=self.cfg.num_classes, lr=lr,
            epochs=epochs,
        )
