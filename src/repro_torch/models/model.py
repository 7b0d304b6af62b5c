"""The LM trunk: embeddings, the block stack and the LM head, for prefill
and for cached single-token decode.

Two structural kinds of the reference's three are ported:
  attn   -- homogeneous attention blocks (GQA with a dense gated FFN)
  zamba  -- Mamba2 blocks plus ONE weight-shared attention block applied
            after every ``shared_attn_every``-th layer (Zamba2)
The ``xlstm`` kind, the stubbed modality frontends, MoE and MLA raise
``NotImplementedError`` (ROADMAP Queue 1 item 14), as does training.

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
reference model's plain PyTorch lowering otherwise.  Decode reaches
neither kernel: it is plain PyTorch on every device, as in the reference.
"""
from __future__ import annotations

import operator
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import blocks
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
    # forward trunk (prefill)
    # ------------------------------------------------------------------
    def trunk(self, params, batch):
        """Returns (x_final (B, T, d), aux_loss, text_offset); aux is 0 (no
        MoE)."""
        cfg = self.cfg
        x, offset = self.embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        if self.kind == "attn":
            for lp, w in zip(params["layers"], layer_windows(cfg).tolist()):
                x = blocks.attn_block_forward(lp, x, positions, cfg, w, self.attn_impl)
        else:
            shared = params["shared_attn"]
            for i, lp in enumerate(params["layers"]):
                x = blocks.mamba_block_forward(lp, x, cfg, self.ssm_impl)
                if (i + 1) % cfg.shared_attn_every == 0:
                    x = blocks.attn_block_forward(shared, x, positions, cfg,
                                                  cfg.sliding_window, self.attn_impl)
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
