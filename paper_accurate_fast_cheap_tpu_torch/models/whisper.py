"""Whisper-style encoder-decoder ASR model (port of the JAX
``models/whisper.py``).

The encoder: two GELU conv1d layers (the second at stride 2), sinusoid
positions added unscaled (``embedding.sinusoid_table``), pre-norm
transformer blocks (``ln1_{i}``, ``attn_{i}``, ``ln2_{i}``, ``mlp_{i}``),
``ln_post``.  The decoder: ``token_embed`` plus learned positions
(``decoder_pos``), ``dec_{i}`` blocks, ``dec_ln``, and the output tied to
``token_embed``.  ``whisper_greedy_decode`` runs the special-token
protocol (a ``sot_sequence`` prefix, stop at ``eot``); GELU is the tanh
form, flax's default.  ``load_hf_whisper_params`` copies the tensors JAX's
loader maps from a transformers ``WhisperForConditionalGeneration``
state_dict (the encoder, ``token_embed`` and ``decoder_pos``) into the
module.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from paper_accurate_fast_cheap_tpu_torch.models.attention import (
    MultiHeadedAttention)
from paper_accurate_fast_cheap_tpu_torch.models.convolution import (
    PositionwiseFeedForward)
from paper_accurate_fast_cheap_tpu_torch.models.decoder import DecoderLayer
from paper_accurate_fast_cheap_tpu_torch.models.embedding import (
    sinusoid_table)
from paper_accurate_fast_cheap_tpu_torch.models.layers import (
    conv, layer_norm, normal_)
from paper_accurate_fast_cheap_tpu_torch.ops.common import (
    IGNORE_ID, accuracy)
from paper_accurate_fast_cheap_tpu_torch.ops.losses import (
    label_smoothing_loss)
from paper_accurate_fast_cheap_tpu_torch.utils.masks import (
    make_pad_mask, subsequent_mask)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class WhisperEncoder(nn.Module):
    def __init__(self, n_mels: int = 80, d_model: int = 512, heads: int = 8,
                 num_blocks: int = 6, ffn_mult: int = 4,
                 max_positions: int = 1500, dropout_rate: float = 0.0):
        super().__init__()
        self.num_blocks = num_blocks
        self.conv1 = nn.Conv1d(n_mels, d_model, 3, padding=1)
        self.conv2 = nn.Conv1d(d_model, d_model, 3, stride=2, padding=1)
        self.register_buffer("pe", torch.from_numpy(
            sinusoid_table(max_positions, d_model)), persistent=False)
        for i in range(num_blocks):
            setattr(self, f"ln1_{i}", nn.LayerNorm(d_model, eps=1e-5))
            setattr(self, f"attn_{i}", MultiHeadedAttention(
                heads, d_model, dropout_rate))
            setattr(self, f"ln2_{i}", nn.LayerNorm(d_model, eps=1e-5))
            setattr(self, f"mlp_{i}", PositionwiseFeedForward(
                d_model, ffn_mult * d_model, dropout_rate,
                activation="gelu"))
        self.ln_post = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, mel: torch.Tensor, mel_lens: torch.Tensor):
        """mel (B, T, n_mels) -> ((B, ceil(T / 2), d), lengths)."""
        x = _gelu(conv(self.conv1, mel.transpose(1, 2)))
        x = _gelu(conv(self.conv2, x)).transpose(1, 2)
        out_lens = (mel_lens + 1) // 2
        T = x.shape[1]
        x = x + self.pe[None, :T]
        att_mask = make_pad_mask(out_lens, T)[:, None, :]
        for i in range(self.num_blocks):
            y = layer_norm(getattr(self, f"ln1_{i}"), x)
            x = x + getattr(self, f"attn_{i}")(y, y, att_mask)
            y = layer_norm(getattr(self, f"ln2_{i}"), x)
            x = x + getattr(self, f"mlp_{i}")(y)
        return layer_norm(self.ln_post, x), out_lens


class WhisperModel(nn.Module):
    # maps a loss's count to the one this rank's shard stands for
    # (``ops/common.normaliser``; set by ``parallel/mesh.share_counts``)
    count_sync = None

    def __init__(self, vocab_size: int = 51865, n_mels: int = 80,
                 d_model: int = 512, heads: int = 8, encoder_blocks: int = 6,
                 decoder_blocks: int = 6, max_target_positions: int = 448,
                 lsm_weight: float = 0.1, ignore_id: int = IGNORE_ID):
        super().__init__()
        self.encoder_blocks = encoder_blocks
        self.decoder_blocks = decoder_blocks
        self.lsm_weight = lsm_weight
        self.ignore_id = ignore_id
        self.encoder = WhisperEncoder(n_mels, d_model, heads, encoder_blocks)
        self.token_embed = nn.Embedding(vocab_size, d_model)
        self.decoder_pos = nn.Parameter(torch.zeros(max_target_positions,
                                                    d_model))
        for i in range(decoder_blocks):
            setattr(self, f"dec_{i}", DecoderLayer(d_model, heads,
                                                   4 * d_model))
        self.dec_ln = nn.LayerNorm(d_model, eps=1e-5)

    def reset_parameters_from(self, g: torch.Generator) -> None:
        normal_(self.decoder_pos, 0.02, g)

    def decode_logits(self, enc, enc_lens, ys, ys_lens):
        U = ys.shape[1]
        x = self.token_embed(ys.long()) + self.decoder_pos[None, :U]
        self_mask = (make_pad_mask(ys_lens, U)[:, None, :]
                     & subsequent_mask(U, ys.device)[None])
        mem_mask = make_pad_mask(enc_lens, enc.shape[1])[:, None, :]
        for i in range(self.decoder_blocks):
            x = getattr(self, f"dec_{i}")(x, self_mask, enc, mem_mask)
        x = layer_norm(self.dec_ln, x)
        # the output embedding is tied to token_embed
        return x @ self.token_embed.weight.to(x.dtype).T

    def forward(self, mel, mel_lens, ys_in, ys_out, ys_lens):
        enc, enc_lens = self.encoder(mel, mel_lens)
        logits = self.decode_logits(enc, enc_lens, ys_in, ys_lens)
        return {"loss": label_smoothing_loss(logits, ys_out, self.lsm_weight,
                                             self.ignore_id),
                "th_accuracy": accuracy(logits, ys_out, self.ignore_id,
                                        self.count_sync)}


@torch.no_grad()
def whisper_greedy_decode(model: WhisperModel, mel: torch.Tensor,
                          mel_lens: torch.Tensor, sot_sequence, eot_id: int,
                          max_len: int = 128,
                          suppress_blank_first: bool = True
                          ) -> List[List[int]]:
    """Greedy decode: the prefix ``sot_sequence`` (e.g. <|sot|>, <|en|>,
    <|transcribe|>, <|notimestamps|>), then the arg-max token at each row's
    last position until <|eot|> or ``max_len``; a host loop, each step the
    decoder over the whole (B, max_len) buffer, as in JAX.  Returns each
    row's tokens after the prefix."""
    B = mel.shape[0]
    dev = mel.device
    enc, enc_lens = model.encoder(mel, mel_lens)
    sot = list(sot_sequence)
    ys = np.full((B, max_len), eot_id, np.int32)
    ys[:, :len(sot)] = sot
    lens = np.full((B,), len(sot), np.int32)
    done = np.zeros((B,), bool)
    rows = torch.arange(B, device=dev)
    for u in range(len(sot), max_len):
        lens_t = torch.from_numpy(lens).to(dev)
        logits = model.decode_logits(enc, enc_lens,
                                     torch.from_numpy(ys).to(dev), lens_t)
        nxt = logits[rows, lens_t.long() - 1].argmax(-1).cpu().numpy()
        for b in range(B):
            if done[b]:
                continue
            tok = int(nxt[b])
            if tok == eot_id:
                done[b] = True
                continue
            ys[b, u] = tok
            lens[b] += 1
        if done.all():
            break
    return [[int(t) for t in ys[b, len(sot):lens[b]]] for b in range(B)]


@torch.no_grad()
def load_hf_whisper_params(hf_state: Dict[str, torch.Tensor],
                           model: WhisperModel) -> WhisperModel:
    """Copy a transformers ``WhisperForConditionalGeneration`` state_dict's
    encoder, token embedding and decoder positions into ``model`` (the
    tensors JAX's loader maps; a missing key raises KeyError).  The layouts
    are PyTorch's on both sides; a key bias HF does not have keeps its
    value."""
    def put(dst: torch.Tensor, name: str) -> None:
        dst.copy_(torch.as_tensor(np.asarray(hf_state[name])))

    enc = model.encoder
    for c in ("conv1", "conv2"):
        put(getattr(enc, c).weight, f"model.encoder.{c}.weight")
        put(getattr(enc, c).bias, f"model.encoder.{c}.bias")
    for i in range(model.encoder_blocks):
        hf = f"model.encoder.layers.{i}."
        attn = getattr(enc, f"attn_{i}")
        for ours, theirs in (("linear_q", "self_attn.q_proj"),
                             ("linear_k", "self_attn.k_proj"),
                             ("linear_v", "self_attn.v_proj"),
                             ("linear_out", "self_attn.out_proj")):
            lin = getattr(attn, ours)
            put(lin.weight, hf + theirs + ".weight")
            if lin.bias is not None and hf + theirs + ".bias" in hf_state:
                put(lin.bias, hf + theirs + ".bias")
        for ln, theirs in (("ln1", "self_attn_layer_norm"),
                           ("ln2", "final_layer_norm")):
            put(getattr(enc, f"{ln}_{i}").weight, hf + theirs + ".weight")
            put(getattr(enc, f"{ln}_{i}").bias, hf + theirs + ".bias")
        mlp = getattr(enc, f"mlp_{i}")
        for ours, theirs in (("Dense_0", "fc1"), ("Dense_1", "fc2")):
            put(getattr(mlp, ours).weight, hf + theirs + ".weight")
            put(getattr(mlp, ours).bias, hf + theirs + ".bias")
    put(enc.ln_post.weight, "model.encoder.layer_norm.weight")
    put(enc.ln_post.bias, "model.encoder.layer_norm.bias")
    put(model.token_embed.weight, "model.decoder.embed_tokens.weight")
    put(model.decoder_pos, "model.decoder.embed_positions.weight")
    return model
