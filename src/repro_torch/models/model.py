"""The LM trunk: embeddings, the block stack and the LM head, for the
training loss, prefill and cached single-token decode, and
``LMClientModel``, the LM as a federated client of ``FedAREngine``.

Two structural kinds of the reference's three are ported:
  attn   -- homogeneous attention blocks (GQA with a dense gated FFN)
  zamba  -- Mamba2 blocks plus ONE weight-shared attention block applied
            after every ``shared_attn_every``-th layer (Zamba2)
The ``xlstm`` kind, the stubbed modality frontends, MoE and MLA raise
``NotImplementedError`` (ROADMAP Queue 1 item 14).

Params are a dict of tensors in the reference's tree, except that
``layers`` is a list with one dict per layer (the reference stacks them on
a leading L axis for ``lax.scan``); the trunk is a Python loop over it.
``convert.lm_params_from_jax`` maps the reference's tree onto this one.
Decode caches mirror that layout (a list per layer; for zamba, lists of
Mamba2 layers and of shared-block applications) and are updated in place
(``convert.lm_cache_from_jax`` maps the reference's stacked cache).

Kernel routing is per model: ``attn_impl`` and ``ssm_impl`` (``auto |
kernel | einsum``, ``kernels/ops.resolve_impl``) pick kernel 8
(``flash_attention``) and kernel 9 (``ssm_scan``) on the card and the
reference model's plain PyTorch lowering otherwise.  The loss and decode
reach neither kernel: they are plain PyTorch on every device, as in the
reference (kernels 8 and 9 have no backward).
"""
from __future__ import annotations

import functools
import operator
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.core.engine import ordered_leaves, resolve_device, with_leaves
from repro_torch.kernels import ops
from repro_torch.models import blocks
from repro_torch.models.client import ClientModel
from repro_torch.models.layers import dense_init, embed_init, rms_norm


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention window (0 = full attention)."""
    L = cfg.num_layers
    if cfg.global_every:
        return np.array(
            [cfg.local_window if (i + 1) % cfg.global_every else cfg.sliding_window
             for i in range(L)],
            np.int32,
        )
    return np.full((L,), cfg.sliding_window, np.int32)


def decode_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Uniform per-layer cache length for decode: the sequence when any
    layer attends in full, else the widest window (a ring buffer)."""
    w = layer_windows(cfg)
    if (w == 0).any():
        return seq_len
    return int(w.max())


class Model:
    """``Model(cfg)`` runs on the card (``device=None`` means ``cuda`` and
    raises without one); pass ``device="cpu"`` for the CPU.  Its methods
    take the params dict explicitly, as the reference's do."""

    def __init__(self, cfg: ModelConfig, device=None, *, attn_impl: str = "auto",
                 ssm_impl: str = "auto"):
        if cfg.family == "ssm" and "s" in cfg.block_pattern:
            raise NotImplementedError("the xlstm kind is not ported yet "
                                      "(ROADMAP Queue 1 item 14)")
        if cfg.frontend:
            raise NotImplementedError(f"the {cfg.frontend} frontend is not ported yet "
                                      "(ROADMAP Queue 1 item 14)")
        blocks.check_attn_block(cfg)
        self.cfg = cfg
        self.kind = "zamba" if cfg.family == "hybrid" and cfg.shared_attn_every else "attn"
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.dtype)
        self.attn_impl = ops.resolve_impl(attn_impl, "attn", self.device)
        self.ssm_impl = ops.resolve_impl(ssm_impl, "ssm", self.device)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init_params(self, generator: torch.Generator) -> Dict[str, Any]:
        """Seeded init drawn on ``generator``'s device and placed on the
        model's: fan-in normal projections and 0.02-normal embeddings in
        ``cfg.dtype``; norm scales, ``A_log``, ``D`` and ``dt_bias`` in fp32."""
        cfg, dtype, dev = self.cfg, self.dtype, self.device
        p: Dict[str, Any] = {
            "embed": embed_init(generator, (cfg.vocab_size, cfg.d_model), dtype, dev),
            "final_norm": torch.zeros(cfg.d_model, dtype=torch.float32, device=dev),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size), 0, dtype,
                                      dev)
        if self.kind == "attn":
            p["layers"] = [blocks.init_attn_block(generator, cfg, dtype, dev)
                           for _ in range(cfg.num_layers)]
        else:
            p["layers"] = [blocks.init_mamba_block(generator, cfg, dtype, dev)
                           for _ in range(cfg.num_layers)]
            p["shared_attn"] = blocks.init_attn_block(generator, cfg, dtype, dev)
        return p

    # ------------------------------------------------------------------
    # embedding / head helpers
    # ------------------------------------------------------------------
    def embed(self, params, batch):
        """Returns (x (B, T, d), text_offset); the offset is 0 without a
        frontend."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        return F.embedding(tokens, params["embed"]), 0

    def logits(self, params, x):
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return torch.matmul(x, head)

    # ------------------------------------------------------------------
    # forward trunk (training / prefill)
    # ------------------------------------------------------------------
    def trunk(self, params, batch, *, remat: bool = False, attn_impl=None,
              ssm_impl=None):
        """Returns (x_final (B, T, d), aux_loss, text_offset); aux is 0 (no
        MoE).  ``remat`` recomputes each block in the backward pass
        (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of
        its scan body); ``attn_impl`` / ``ssm_impl`` override the model's
        routes for this call."""
        cfg = self.cfg
        attn_impl = self.attn_impl if attn_impl is None else attn_impl
        ssm_impl = self.ssm_impl if ssm_impl is None else ssm_impl
        x, offset = self.embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)

        def run(block, *args):
            if remat and torch.is_grad_enabled():
                return checkpoint(block, *args, use_reentrant=False)
            return block(*args)

        if self.kind == "attn":
            for lp, w in zip(params["layers"], layer_windows(cfg).tolist()):
                x = run(blocks.attn_block_forward, lp, x, positions, cfg, w, attn_impl)
        else:
            shared = params["shared_attn"]
            for i, lp in enumerate(params["layers"]):
                x = run(blocks.mamba_block_forward, lp, x, cfg, ssm_impl)
                if (i + 1) % cfg.shared_attn_every == 0:
                    x = run(blocks.attn_block_forward, shared, x, positions, cfg,
                            cfg.sliding_window, attn_impl)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux, offset

    def forward(self, params, batch):
        """Logits at every position, (B, T, vocab), and the aux loss."""
        with torch.inference_mode():
            x, aux, _ = self.trunk(params, batch)
            return self.logits(params, x), aux

    def prefill(self, params, batch):
        """Serving prefill: logits for the LAST position only, (B, vocab)."""
        with torch.inference_mode():
            x, _, _ = self.trunk(params, batch)
            return self.logits(params, x[:, -1, :])

    # ------------------------------------------------------------------
    # loss
    # ------------------------------------------------------------------
    def _nll_sum(self, params, batch, remat: bool, loss_chunk: int, per_row: bool):
        """The summed next-token NLL, (B,) per row or () in all, and aux.
        The trunk takes the plain attention and scan routes whatever the
        model's routes say: kernels 8 and 9 have no backward (their
        wrappers raise on an input that requires grad), and the reference's
        loss reaches no Pallas kernel."""
        x, aux, offset = self.trunk(params, batch, remat=remat, attn_impl="einsum",
                                    ssm_impl="einsum")
        x = x[:, offset:, :]
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        B, S = labels.shape
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]

        def ce(xc, yc):
            lg = torch.matmul(xc, head).to(torch.float32)
            nll = torch.logsumexp(lg, dim=-1) - torch.gather(lg, -1, yc[..., None])[..., 0]
            return nll.sum(dim=-1) if per_row else nll.sum()

        if loss_chunk and S % loss_chunk == 0 and S > loss_chunk:
            # position chunks summed in order, as the reference's scan
            total = torch.zeros((B,) if per_row else (), dtype=torch.float32,
                                device=x.device)
            for c in range(0, S, loss_chunk):
                total = total + ce(x[:, c:c + loss_chunk], labels[:, c:c + loss_chunk])
        else:
            total = ce(x, labels)
        return total, aux, B, S

    def loss(self, params, batch, remat: bool = True, loss_chunk: int = 0):
        """Causal LM loss: batch ``tokens`` (B, S) and ``labels`` (B, S),
        labels[t] predicted from position t.  ``loss_chunk`` takes the
        logits ``loss_chunk`` positions at a time.  Returns (nll + aux,
        {"nll", "aux"})."""
        total, aux, B, S = self._nll_sum(params, batch, remat, loss_chunk, False)
        nll = total / (B * S)
        return nll + aux, {"nll": nll, "aux": aux}

    def loss_per_example(self, params, batch, remat: bool = True,
                         loss_chunk: int = 0):
        """Per-row mean NLL (B,) and the aux loss."""
        total, aux, _, S = self._nll_sum(params, batch, remat, loss_chunk, True)
        return total / S, aux

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int):
        """Zeroed decode caches for ``batch`` sequences of up to ``seq_len``
        tokens, made in inference mode as ``decode_step`` updates them:
        ``attn`` a list of per-layer KV caches; ``zamba`` ``{"mamba": [per
        layer conv + fp32 SSM state], "attn": [per shared-block
        application KV cache]}``.  KV and conv caches in ``cfg.dtype``."""
        cfg, dtype, dev = self.cfg, self.dtype, self.device
        clen = decode_cache_len(cfg, seq_len)
        with torch.inference_mode():
            if self.kind == "attn":
                return [blocks.init_attn_block_cache(cfg, batch, clen, dtype, dev)
                        for _ in range(cfg.num_layers)]
            n_attn = cfg.num_layers // cfg.shared_attn_every
            return {
                "mamba": [blocks.init_mamba_block_cache(cfg, batch, dtype, dev)
                          for _ in range(cfg.num_layers)],
                "attn": [blocks.init_attn_block_cache(cfg, batch, clen, dtype, dev)
                         for _ in range(n_attn)],
            }

    def decode_step(self, params, cache, tokens, pos: int):
        """One decode step.  tokens: (B, 1) ints, on the model's device to
        keep the step free of host syncs; pos: the new token's index, a
        Python int.  Updates ``cache`` in place and returns (logits (B,
        vocab), the same cache object)."""
        cfg = self.cfg
        pos = operator.index(pos)
        with torch.inference_mode():
            x, _ = self.embed(params, {"tokens": tokens})
            if self.kind == "attn":
                for lp, lc, w in zip(params["layers"], cache, layer_windows(cfg).tolist()):
                    x, _ = blocks.attn_block_decode(lp, lc, x, pos, cfg, w)
            else:
                shared, every = params["shared_attn"], cfg.shared_attn_every
                for i, (lp, lc) in enumerate(zip(params["layers"], cache["mamba"])):
                    x, _ = blocks.mamba_block_decode(lp, lc, x, cfg)
                    if (i + 1) % every == 0:
                        ac = cache["attn"][(i + 1) // every - 1]
                        x, _ = blocks.attn_block_decode(shared, ac, x, pos, cfg,
                                                        cfg.sliding_window)
            x = rms_norm(x, params["final_norm"], cfg.norm_eps)
            return self.logits(params, x[:, 0, :]), cache


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return sum(int(leaf.numel()) for leaf in _leaves(params))


class LMClientModel(ClientModel):
    """Transformer LM client behind the engine's ``ClientModel`` surface.

    Wraps ``Model`` (the ported kinds, usually a ``.reduced()`` config) so
    ``FedAREngine`` runs trust scoring, straggler masking, buffered async
    aggregation and the sketched defense over transformer clients.  The
    param tree crosses the aggregation boundary through
    ``core.engine.flatten`` / ``unflatten`` (per-leaf dtypes survive the
    fp32 flat view).  ``device`` ``None`` means the card, as for ``Model``.

    Data fields: ``tokens`` (n, S) int sequences and ``labels`` (n, S)
    shifted targets; one client holds n sequences.  ClientUpdate mirrors
    the reference's batching: without a sample mask the batch count
    floors, with one it ceils and pads with mask-False rows, so trailing
    sequences still train.  The clients of a block train one after
    another, each straight into its row of one (R, D) flat buffer.

    There is no fused local-SGD kernel for this family
    (``supports_fused=False``): ``sgd_impl="auto"`` runs ``client_update``
    and ``"kernel"`` raises; the packed bucketed layout is unsupported.
    ``metrics`` takes the model's own routes for its forward (kernel 8 on
    the card, unless ``attn_impl="einsum"``); the loss and its gradient
    always take the plain ones.
    """

    family = "lm"
    data_keys = ("tokens", "labels")
    supports_fused = False
    packed_supported = False

    def __init__(self, cfg: ModelConfig, *, remat: bool = False, device=None,
                 attn_impl: str = "auto"):
        self.cfg = cfg
        self.model = Model(cfg, device, attn_impl=attn_impl)
        self.device = self.model.device
        self.remat = remat
        self._dim = None  # the param count, for train_flops

    def init(self, generator, device):
        if torch.device(device).type != self.device.type:
            raise ValueError(f"the engine runs on {device}, the model on {self.device}")
        params = self.model.init_params(generator)
        self.adopt_template(params)
        return params

    def adopt_template(self, template) -> None:
        self._dim = param_count(template)

    def loss(self, params, fields, sample_mask=None):
        batch = {"tokens": fields["tokens"], "labels": fields["labels"]}
        per_row, aux = self.model.loss_per_example(params, batch, remat=self.remat)
        if sample_mask is None:
            return per_row.mean() + aux
        m = sample_mask.to(per_row.dtype)
        return (per_row * m).sum() / torch.clamp(m.sum(), min=1.0) + aux

    def client_update(self, params, fields, *, lr, batch_size, epochs,
                      sample_mask=None):
        """E epochs of plain SGD ``p - lr * g`` per leaf, in the leaf's own
        dtype, for each client of the block in turn.  Returns the (R, D)
        flat rows (fp32 for a bf16 model), in ``core.engine.flatten``
        order."""
        tokens = torch.as_tensor(fields["tokens"], device=self.device).long()
        labels = torch.as_tensor(fields["labels"], device=self.device).long()
        leaves = [leaf for _, leaf in ordered_leaves(params)]
        dtype = functools.reduce(torch.promote_types, (t.dtype for t in leaves))
        out = torch.empty((tokens.shape[0], sum(t.numel() for t in leaves)),
                          dtype=dtype, device=self.device)
        for i in range(tokens.shape[0]):
            m = None if sample_mask is None else sample_mask[i]
            off = 0
            for t in self._local_sgd(params, tokens[i], labels[i], m, lr,
                                     batch_size, epochs):
                out[i, off:off + t.numel()] = t.reshape(-1)
                off += t.numel()
        return out

    def _local_sgd(self, params, tokens, labels, mask, lr, batch_size, epochs):
        """One client's ClientUpdate -> its trained leaves in flat order."""
        n = tokens.shape[0]
        if mask is None:
            nb = n // batch_size
            tb = tokens[:nb * batch_size].reshape(nb, batch_size, -1)
            lb = labels[:nb * batch_size].reshape(nb, batch_size, -1)
            mb = [None] * nb
        else:
            nb = -(-n // batch_size)  # ceil: never drop real sequences
            pad = nb * batch_size - n
            tb = F.pad(tokens, (0, 0, 0, pad)).reshape(nb, batch_size, -1)
            lb = F.pad(labels, (0, 0, 0, pad)).reshape(nb, batch_size, -1)
            mb = torch.cat([mask.to(torch.bool),
                            mask.new_zeros(pad, dtype=torch.bool)]).reshape(nb, batch_size)
        leaves = [leaf.detach().clone().requires_grad_(True)
                  for _, leaf in ordered_leaves(params)]
        # the reference's step size is a weak-typed Python float: it enters
        # each leaf's update in that leaf's dtype
        step = {t.dtype: torch.tensor(lr, dtype=t.dtype, device=self.device)
                for t in leaves}
        for _ in range(epochs):
            for b in range(nb):
                with torch.enable_grad():
                    loss = self.loss(with_leaves(params, leaves),
                                     {"tokens": tb[b], "labels": lb[b]}, mb[b])
                    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                with torch.no_grad():
                    for p, g in zip(leaves, grads):
                        if g is not None:
                            p.sub_(g.mul_(step[p.dtype]))
        return [t.detach() for t in leaves]

    def metrics(self, params, eval_set):
        """(loss, token accuracy) on the held-out ``eval_set`` (``tokens``,
        ``labels``)."""
        batch = {"tokens": eval_set["tokens"], "labels": eval_set["labels"]}
        with torch.no_grad():
            total, _ = self.model.loss(params, batch, remat=self.remat)
            logits, _ = self.model.forward(params, batch)
            labels = torch.as_tensor(batch["labels"], device=self.device)
            acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
        return total, acc

    def train_flops(self, sample_shape, *, epochs) -> float:
        """6 N_params FLOPs a token (forward and backward) x n sequences of
        length S x E epochs."""
        if self._dim is None:
            raise RuntimeError("call init() before train_flops()")
        n, seq = sample_shape[0], sample_shape[1]
        return float(6.0 * epochs * n * seq * self._dim)
