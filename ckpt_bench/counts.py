"""Operations and bytes computed from shapes, and the card's peaks.

Peaks: one NVIDIA H100 SXM5 (datasheet, dense rates): 989.4 TFLOP/s in
bfloat16 on the tensor cores and 3.35 TB/s of HBM3. A result states the
card's power limit beside any share of them.

``train_flops`` counts a training step's model operations: two per
multiply-add of every matrix product the model needs, forward, times
three for forward and backward. Remat's recompute is not counted. For
Whisper that is every encoder frame through the encoder's projections
and MLP and its attention over all frames; every decoder token through
the decoder's self-attention (causal: a token attends to itself and the
tokens before it, half of the square on average), its projections, its
cross-attention over all frames and its MLP; the cross-attention keys
and values of every frame in every decoder layer; and the tied head
over every position.

``fused_precodec_bytes`` is the fused pass's traffic for one staged
stream of ``n`` 32-bit words in chunks of ``chunk_words``: the stream
and its base read, the delta written (4 bytes a word each), and a meta
row of three words per chunk written (the count that ``chip_smoke.py``'s
roofline of the kernel uses).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12


def whisper_forward_macs(cfg: Dict[str, Any], batch: int, seq: int, *,
                         causal_half: bool = True) -> float:
    """Multiply-adds of one forward pass (``causal_half=False`` counts
    the decoder's full square of self-attention scores, as an unmasked
    product computes it)."""
    d, ff, v, t = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"], cfg["enc_seq"]
    hd = d // cfg["n_heads"]
    kv = cfg["n_kv_heads"] * hd
    proj = 2 * d * d + 2 * d * kv           # q, o and k, v
    mlp = 2 * d * ff
    enc_frame = proj + mlp + 2 * t * d      # scores and values over every frame
    self_keys = (seq + 1) / 2 if causal_half else seq
    dec_token = proj + 2 * d * d + mlp + 2 * self_keys * d + 2 * t * d
    cross_kv = t * 2 * d * kv               # a row's frames through k and v
    return (batch * t * enc_frame * cfg["n_enc_layers"]
            + batch * (seq * dec_token + cross_kv) * cfg["n_layers"]
            + batch * seq * d * v)


def train_flops(cfg: Dict[str, Any], batch: int, seq: int) -> Optional[float]:
    """Model FLOPs of one training step, or None for a family this
    module does not count."""
    if cfg.get("family") == "audio":
        return 3 * 2 * whisper_forward_macs(cfg, batch, seq)
    return None


def fused_precodec_bytes(n_words: int, chunk_words: int) -> int:
    n_chunks = -(-n_words // chunk_words)
    return 12 * n_words + 12 * n_chunks
