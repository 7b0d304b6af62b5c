"""Uplink delta compression (selected by ``FedConfig.compress``).

A strategy owns the per-client error-feedback residual block carried in
the engine state and the encode/decode pair applied at the client ->
server boundary:

  ``none`` -- raw deltas, zero-width residual; the engine skips the
              roundtrip, so the path is the uncompressed one exactly.
  ``qsgd`` -- stochastic uniform quantization at ``compress_bits`` in
              {4, 8}: per-client max-|v| scale, codes stochastically
              rounded (unbiased decode), packed to uint8 by the
              ``pack_codes`` kernel (two codes per byte at 4 bits).
              Payload ceil(D * bits / 8) + 4 bytes per client.
  ``topk`` -- magnitude top-``compress_k``: the k largest-|v| coordinates
              ship as (value, index) pairs, 8 * k bytes per client, and the
              server decodes them with the ``topk_decode`` kernel.

Error feedback: each client compresses ``delta + residual`` and carries
``residual' = (delta + residual) - decode(payload)`` to the next round it
transmits; the decoded payloads plus the final residual sum to the raw
deltas.  Non-transmitting clients keep their residual and send zeros.

QSGD's stochastic-rounding uniforms are an (n, D) tensor from the draw
provider (``convert.GeneratorDraws.uniform`` / ``ReplayDraws.uniform``),
where the reference folds a threefry key per canonical client id.  The
codec kernels route through ``FedConfig.compress_impl``
(``kernels.ops.resolve_impl``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.common.config import FedConfig
from repro_torch.kernels import compress as codec
from repro_torch.kernels import ref
from repro_torch.kernels.ops import resolve_impl

__all__ = ["CompressionStrategy", "NoCompression", "QSGDCompression",
           "TopKCompression", "make_compression", "make_residual"]


def _on_kernel(impl: str, t: torch.Tensor) -> bool:
    """``compress_impl`` resolved for tensors on ``t``'s device."""
    return resolve_impl(impl, "compress", t.device) == "kernel"


class CompressionStrategy:
    """Interface the engine's round calls, strategy-agnostically.

    ``active``          -- False only for ``none``: the engine skips the
                           roundtrip and carries a width-0 residual.
    ``residual_dim``    -- width of the carried error-feedback block.
    ``payload_nbytes``  -- nominal uplink bytes per client per round.
    ``encode``          -- compress ``deltas + residual`` with the (n, D)
                           uniforms ``unif`` (``None`` where the strategy
                           draws nothing); returns the payload dict and the
                           post-encode residual of every row.
    ``decode``          -- payload dict -> (n, D) float32 decoded deltas.
    """

    name = "none"
    active = False
    needs_uniforms = False

    def residual_dim(self, model_dim: int) -> int:
        return 0

    def payload_nbytes(self, model_dim: int) -> int:
        return 4 * model_dim  # dense fp32

    def encode(self, deltas, residual, unif):
        raise NotImplementedError

    def decode(self, payload, model_dim: int):
        raise NotImplementedError

    def roundtrip(self, deltas, residual, transmit, unif):
        """Encode/decode ``deltas + residual`` with error feedback, gated on
        the (n,) ``transmit`` mask.  Returns ``(decoded, new_residual,
        payload)``; non-transmitting rows decode to exact zeros and keep
        their residual."""
        payload, res = self.encode(deltas, residual, unif)
        dec = self.decode(payload, deltas.shape[-1])
        m = transmit[:, None]
        return torch.where(m, dec, 0.0), torch.where(m, res, residual), payload


class NoCompression(CompressionStrategy):
    """Raw fp32 deltas; the engine never calls encode/decode."""

    def encode(self, deltas, residual, unif):
        return {"dense": deltas + residual}, torch.zeros_like(residual)

    def decode(self, payload, model_dim: int):
        return payload["dense"]


class QSGDCompression(CompressionStrategy):
    """Stochastic uniform quantization at ``compress_bits`` levels.

    ``L = 2^(bits-1) - 1`` levels per sign; code ``q = round_stoch(|v| /
    scale * L) * sign(v)`` with per-row ``scale = max|v|``, shipped
    offset-encoded (``q + L``) in packed uint8; decode ``(q * scale) / L``.
    The op order is the reference's, so the same ``v`` and uniforms give
    the same codes bit for bit.  An all-zero row encodes and decodes to
    exact zeros."""

    name = "qsgd"
    active = True
    needs_uniforms = True

    def __init__(self, fed: FedConfig, model_dim: int):
        if fed.compress_bits not in (4, 8):
            raise ValueError(
                f"FedConfig.compress_bits={fed.compress_bits!r} unsupported "
                "for compress='qsgd' — the uint8 pack kernel handles 4 "
                "(two codes per byte) or 8 (one code per byte)"
            )
        self.bits = fed.compress_bits
        self.levels = 2 ** (fed.compress_bits - 1) - 1
        self.impl = fed.compress_impl

    def residual_dim(self, model_dim: int) -> int:
        return model_dim

    def payload_nbytes(self, model_dim: int) -> int:
        return math.ceil(model_dim * self.bits / 8) + 4  # codes + fp32 scale

    def encode(self, deltas, residual, unif):
        v = (deltas + residual).to(torch.float32)
        L = float(self.levels)
        scale = v.abs().amax(dim=-1, keepdim=True)  # (n, 1)
        safe = torch.where(scale > 0.0, scale, 1.0)
        u = v.abs() / safe * L  # in [0, L]
        low = torch.floor(u)
        q = (low + (unif < u - low)).to(torch.int32)  # stochastic round
        q = torch.where(scale > 0.0, q * torch.sign(v).to(torch.int32), 0)
        codes = q + self.levels  # offset to [0, 2L]
        pack = codec.pack_codes if _on_kernel(self.impl, v) else ref.pack_codes_ref
        payload = {"codes": pack(codes, bits=self.bits), "scale": scale}
        return payload, v - self.decode(payload, v.shape[-1])

    def decode(self, payload, model_dim: int):
        packed = payload["codes"]
        unpack = (codec.unpack_codes if _on_kernel(self.impl, packed)
                  else ref.unpack_codes_ref)
        codes = unpack(packed, bits=self.bits, dim=model_dim)
        q = codes.to(torch.float32) - float(self.levels)
        return q * payload["scale"] / float(self.levels)


class TopKCompression(CompressionStrategy):
    """Magnitude top-``compress_k``: ship the k largest-|v| coordinates as
    (value, index) pairs.  ``k == D`` is an exact identity; ``k`` defaults
    to ``D // 32``.  Biased; error feedback carries what was dropped.  A
    tie in |v| at the k-th place may keep another index than the
    reference's ``lax.top_k``."""

    name = "topk"
    active = True

    def __init__(self, fed: FedConfig, model_dim: int):
        k = fed.compress_k if fed.compress_k is not None else max(
            1, model_dim // 32
        )
        if not 1 <= k <= model_dim:
            raise ValueError(
                f"FedConfig.compress_k={fed.compress_k!r} out of range for "
                f"compress='topk' with model_dim={model_dim} — need "
                f"1 <= k <= D (k == D is the exact-identity degenerate case)"
            )
        self.k = int(k)
        self.impl = fed.compress_impl

    def residual_dim(self, model_dim: int) -> int:
        return model_dim

    def payload_nbytes(self, model_dim: int) -> int:
        return 8 * self.k  # fp32 value + int32 index per kept coordinate

    def encode(self, deltas, residual, unif):
        v = (deltas + residual).to(torch.float32)
        idx = torch.topk(v.abs(), self.k, dim=-1).indices
        payload = {"vals": torch.gather(v, -1, idx), "idx": idx.to(torch.int32)}
        return payload, v - self.decode(payload, v.shape[-1])

    def decode(self, payload, model_dim: int):
        vals = payload["vals"]
        decode = codec.topk_decode if _on_kernel(self.impl, vals) else ref.topk_decode_ref
        return decode(vals, payload["idx"], model_dim)


_STRATEGIES = {
    "none": NoCompression,
    "qsgd": QSGDCompression,
    "topk": TopKCompression,
}


def make_compression(fed: FedConfig, model_dim: int) -> CompressionStrategy:
    """Build the strategy ``FedConfig.compress`` names (validating the
    bits / k knobs and the aggregation mode)."""
    try:
        cls = _STRATEGIES[fed.compress]
    except KeyError:
        raise ValueError(
            f"unknown FedConfig.compress={fed.compress!r} "
            f"(known: {sorted(_STRATEGIES)})"
        ) from None
    if cls is NoCompression:
        return NoCompression()
    if fed.aggregation == "async_seq":
        raise ValueError(
            f"FedConfig.compress={fed.compress!r} does not compose with "
            "aggregation='async_seq': the sequential fold aggregates full "
            "local MODELS, never the decoded deltas, so the error-feedback "
            "residual would silently drift from what lands in the global "
            "model — use aggregation='async' (the buffered mode transmits "
            "exactly when its slot can admit) or compress='none'"
        )
    return cls(fed, model_dim)


def make_residual(num_clients: int, residual_dim: int, device="cpu",
                  dtype=torch.float32) -> torch.Tensor:
    """Fresh all-zero residual block (width 0 when compression is off)."""
    return torch.zeros((num_clients, residual_dim), dtype=dtype, device=device)
