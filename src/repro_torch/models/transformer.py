"""Config-driven transformer LM family (port of ``repro.models.transformer``):
forward, the loss value and the serving path (prefill, decode).

One composable definition covers the five LM archs, as in JAX: llama-style
GQA + SwiGLU (deepseek-coder-33b, minicpm-2b), local/global alternation
with softcaps and sandwich norms (gemma2-2b), MoE every layer
(olmoe-1b-7b) or interleaved with chunked-local and NoPE global attention
(llama4-maverick).

JAX stacks the blocks as ``[n_groups, ...]`` with ``layer_{j}`` inside a
group and scans over groups; the port holds a flat ``ModuleList``. Layer
``i`` is group ``i // group_size``, slot ``j = i % group_size``, and takes
its kind and MoE-ness from ``j``. A parameter's dotted name in the port,
``blocks.{i}.attn.wq.kernel``, is JAX's path ``blocks/layer_{j}/attn/wq/
kernel`` at index ``[i // group_size]`` (``jax_path``); ``params_from_jax``
and ``params_to_numpy`` carry a model across both ways.

Prefill and forward attention take the route ``nn.attention`` chooses per
layer: the ``mha`` kernel on the card where it applies, the scan
elsewhere. Decode attention and every projection stay ``torch.matmul`` /
einsum, as JAX leaves them to XLA. Caches are a list of ``KVCache``, one
per layer; decode writes them in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ..kernels.common import resolve_device, tensor_from_numpy
from ..nn.attention import (
    Attention,
    AttnSettings,
    KVCache,
    _project_qkv,
    attend,
    cache_from_kv,
    decode_step as attn_decode,
    init_cache as attn_init_cache,
)
from ..nn.layers import Embedding, RMSNorm, rmsnorm, softcap
from ..nn.module import cast_scalar, shard_activation
from ..nn.moe import MoE, MoESettings, SwiGLU, ffn, moe


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 1e4
    layer_pattern: tuple = ("global",)  # cycled attention kinds
    window: int = 4096  # for local/chunk kinds
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    use_post_norm: bool = False  # gemma2 sandwich norms
    qk_norm: bool = False
    moe: Optional[MoESettings] = None
    tie_embeddings: bool = True
    emb_scale: Optional[float] = None
    logit_scale: float = 1.0
    residual_scale: float = 1.0
    norm_eps: float = 1e-6
    zero_centered_norm: bool = False
    dtype: Any = torch.float32
    remat: str = "dots"  # none | dots | full (training; unused when serving)
    attn_chunk: int = 512
    query_scale: Optional[float] = None
    # cross-entropy sequence chunk: the [B, S, vocab] logits tensor is
    # never materialized, the loss streams over S in ce_chunk slices
    ce_chunk: int = 512

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 256) * 256

    @property
    def group_size(self) -> int:
        p = len(self.layer_pattern)
        m = self.moe.every if self.moe else 1
        return p * m // math.gcd(p, m)

    @property
    def n_groups(self) -> int:
        if self.n_layers % self.group_size:
            raise ValueError(f"{self.n_layers} layers do not split into "
                             f"groups of {self.group_size}")
        return self.n_layers // self.group_size

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def layer_is_moe(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe.every
                                         == self.moe.every - 1)

    def attn_settings(self, kind: str) -> AttnSettings:
        return AttnSettings(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            d_head=self.d_head,
            rope_theta=self.rope_theta,
            kind=kind,
            window=self.window,
            logit_softcap=self.attn_logit_softcap,
            qk_norm=self.qk_norm,
            chunk_q=self.attn_chunk,
            query_scale=self.query_scale,
        )

    def active_params(self) -> int:
        """Analytic active-parameter count (for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.d_head
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        dense_ffn = 3 * d * self.d_ff
        n_moe = sum(self.layer_is_moe(i) for i in range(self.n_layers))
        n_dense = self.n_layers - n_moe
        total = attn * self.n_layers + dense_ffn * n_dense
        if self.moe:
            act = 3 * d * self.moe.d_ff * (
                self.moe.top_k + self.moe.n_shared
            ) + d * self.moe.n_experts
            total += act * n_moe
        total += self.vocab * d * (1 if self.tie_embeddings else 2)
        return total

    def total_params(self) -> int:
        d = self.d_model
        total = self.active_params()
        if self.moe:
            n_moe = sum(self.layer_is_moe(i) for i in range(self.n_layers))
            total += (3 * d * self.moe.d_ff
                      * (self.moe.n_experts - self.moe.top_k) * n_moe)
        return total


# ----------------------------------------------------------------- init ----

class Layer(nn.Module):
    """One block: JAX's ``layer_{j}`` dict for group slot ``j``."""

    def __init__(self, cfg: TransformerConfig, j: int, generator, device):
        super().__init__()
        dt = cfg.dtype
        self.ln_attn = RMSNorm(cfg.d_model, dt, device)
        self.attn = Attention(cfg.attn_settings(cfg.layer_kind(j)),
                              generator, dt, device)
        self.ln_mlp = RMSNorm(cfg.d_model, dt, device)
        if cfg.layer_is_moe(j):
            self.moe = MoE(cfg.d_model, cfg.moe, generator, dt, device)
        else:
            self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, generator, dt, device)
        if cfg.use_post_norm:
            self.ln_attn_post = RMSNorm(cfg.d_model, dt, device)
            self.ln_mlp_post = RMSNorm(cfg.d_model, dt, device)


class Transformer(nn.Module):
    """``embed``, ``blocks`` (one ``Layer`` per layer), ``ln_final`` and,
    untied, ``unembed``. Calling it runs ``forward``."""

    def __init__(self, cfg: TransformerConfig, generator, device):
        super().__init__()
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_padded, cfg.d_model, generator,
                               cfg.dtype, device)
        self.blocks = nn.ModuleList(
            Layer(cfg, i % cfg.group_size, generator, device)
            for i in range(cfg.group_size * cfg.n_groups))
        self.ln_final = RMSNorm(cfg.d_model, cfg.dtype, device)
        if not cfg.tie_embeddings:
            self.unembed = Embedding(cfg.vocab_padded, cfg.d_model,
                                     generator, cfg.dtype, device)

    def forward(self, tokens, positions=None, route=None):
        return forward(self, self.cfg, tokens, positions, route)


def _device(device) -> torch.device:
    """``resolve_device``, and ``meta`` for shapes without storage."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def init(cfg: TransformerConfig, generator: Optional[torch.Generator],
         device=None) -> Transformer:
    """A model with seeded weights drawn from ``generator`` (on its own
    device) and placed on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``; ``"meta"`` builds the shapes alone, with no generator)."""
    dev = _device(device)
    if generator is None and dev.type != "meta":
        raise ValueError("init needs a torch.Generator for its weights")
    return Transformer(cfg, generator, dev)


# -------------------------------------------------------------- forward ----

def _norm(cfg, p, x):
    return rmsnorm(p, x, cfg.norm_eps, cfg.zero_centered_norm)


def _residual(cfg, x, h):
    return x + h * cast_scalar(cfg.residual_scale, h.dtype)


def _layer_apply(lp: Layer, cfg: TransformerConfig, j: int, x, positions,
                 route=None, max_seq=None):
    """One block -> (x, aux, the layer's prefill cache when ``max_seq`` is
    given). The cache comes from the same normed input's k and v."""
    s = cfg.attn_settings(cfg.layer_kind(j))
    h_in = shard_activation(_norm(cfg, lp.ln_attn, x), ("batch", None, None))
    q, k, v = _project_qkv(lp.attn, s, h_in, positions)
    cache = (None if max_seq is None
             else cache_from_kv(s, k, v, positions, max_seq))
    h = attend(lp.attn, s, q, k, v, positions, route)
    del q, k, v  # not held through the MLP
    if cfg.use_post_norm:
        h = _norm(cfg, lp.ln_attn_post, h)
    x = _residual(cfg, x, h)
    m_in = shard_activation(_norm(cfg, lp.ln_mlp, x), ("batch", None, None))
    if cfg.layer_is_moe(j):
        h, aux = moe(lp.moe, cfg.moe, m_in)
    else:
        h = ffn(lp.mlp, m_in)
        aux = torch.zeros((), device=x.device)
    if cfg.use_post_norm:
        h = _norm(cfg, lp.ln_mlp_post, h)
    x = _residual(cfg, x, h)
    return shard_activation(x, ("batch", "res_seq", None)), aux, cache


def _embed_tokens(params: Transformer, cfg, tokens):
    x = params.embed.table[tokens]
    if cfg.emb_scale is not None:
        x = x * cast_scalar(cfg.emb_scale, x.dtype)
    return shard_activation(x, ("batch", "res_seq", None))


def _unembed(params: Transformer, cfg, x):
    table = (params.embed.table if cfg.tie_embeddings
             else params.unembed.table)
    logits = (x @ table.T).float() * cfg.logit_scale
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    if cfg.vocab_padded != cfg.vocab:  # mask vocab padding
        logits[..., cfg.vocab:] = -1e30
    return shard_activation(logits, ("batch", None, "act_vocab"))


def _positions(b: int, seq: int, device) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device).expand(b, seq)


def hidden_states(params: Transformer, cfg: TransformerConfig, tokens,
                  positions=None, route=None):
    """tokens [B, S] -> (final-norm hidden [B, S, d], total aux loss).
    Caller-given positions keep attention on the scan route unless
    ``route`` says otherwise (the kernel masks by index)."""
    b, seq = tokens.shape
    if positions is None:
        positions = _positions(b, seq, tokens.device)
    elif route is None:
        route = "scan"
    x = _embed_tokens(params, cfg, tokens)
    aux = torch.zeros((), device=x.device)
    for i, lp in enumerate(params.blocks):
        x, a, _ = _layer_apply(lp, cfg, i % cfg.group_size, x, positions,
                               route)
        aux = aux + a
    return _norm(cfg, params.ln_final, x), aux


def forward(params: Transformer, cfg: TransformerConfig, tokens,
            positions=None, route=None):
    """tokens [B, S] -> (logits [B, S, vocab_padded], total aux loss)."""
    x, aux = hidden_states(params, cfg, tokens, positions, route)
    return _unembed(params, cfg, x), aux


def loss_fn(params: Transformer, cfg: TransformerConfig, batch):
    """batch {"tokens": [B, S], "labels": [B, S]} -> the scalar loss value
    (streamed cross-entropy over ``ce_chunk`` slices, plus aux). The
    gradient comes with the training slice."""
    x, aux = hidden_states(params, cfg, batch["tokens"])
    b, seq, _ = x.shape
    c = min(cfg.ce_chunk, seq)
    if seq % c:
        raise ValueError(f"S={seq} is not a multiple of ce_chunk {c}")
    labels = batch["labels"].long()
    total = torch.zeros((), device=x.device)
    for start in range(0, seq, c):
        logits = _unembed(params, cfg, x[:, start:start + c])
        logp = torch.log_softmax(logits, dim=-1)
        ll = logp.gather(-1, labels[:, start:start + c, None])[..., 0]
        total = total + ll.sum()
    return -total / (b * seq) + aux


# --------------------------------------------------------------- serving ---

def init_model_cache(cfg: TransformerConfig, batch: int, max_seq: int,
                     dtype=torch.bfloat16, device=None) -> list:
    dev = resolve_device(device)
    return [attn_init_cache(cfg.attn_settings(cfg.layer_kind(i)), batch,
                            max_seq, dtype, dev)
            for i in range(cfg.n_layers)]


def _layer_decode(lp: Layer, cfg, j, x, cache: KVCache, pos: int):
    h, cache = attn_decode(lp.attn, cfg.attn_settings(cfg.layer_kind(j)),
                           _norm(cfg, lp.ln_attn, x), cache, pos)
    if cfg.use_post_norm:
        h = _norm(cfg, lp.ln_attn_post, h)
    x = _residual(cfg, x, h)
    if cfg.layer_is_moe(j):
        h, _ = moe(lp.moe, cfg.moe, _norm(cfg, lp.ln_mlp, x))
    else:
        h = ffn(lp.mlp, _norm(cfg, lp.ln_mlp, x))
    if cfg.use_post_norm:
        h = _norm(cfg, lp.ln_mlp_post, h)
    return _residual(cfg, x, h), cache


def decode(params: Transformer, cfg: TransformerConfig, caches, tokens,
           pos: int):
    """One decode step: tokens [B, 1], ``pos`` an int -> (logits [B, 1,
    vocab_padded], caches; each layer's cache written in place)."""
    x = _embed_tokens(params, cfg, tokens)
    new_caches = []
    for i, lp in enumerate(params.blocks):
        x, c = _layer_decode(lp, cfg, i % cfg.group_size, x, caches[i], pos)
        new_caches.append(c)
    x = _norm(cfg, params.ln_final, x)
    return _unembed(params, cfg, x), new_caches


def prefill(params: Transformer, cfg: TransformerConfig, tokens,
            max_seq=None, route=None):
    """tokens [B, S] -> (last-position logits [B, vocab_padded], caches
    ready for decode at pos=S). Each layer's cache holds the k and v that
    its attention used (positions 0..S-1 on every row)."""
    b, seq = tokens.shape
    max_seq = max_seq or seq
    positions = _positions(b, seq, tokens.device)
    x = _embed_tokens(params, cfg, tokens)
    caches = []
    for i, lp in enumerate(params.blocks):
        x, _, c = _layer_apply(lp, cfg, i % cfg.group_size, x, positions,
                               route, max_seq)
        caches.append(c)
    x = _norm(cfg, params.ln_final, x)
    logits = _unembed(params, cfg, x[:, -1:, :])
    return logits[:, 0, :], caches


# ------------------------------------------------- carrying weights across --

def jax_path(cfg: TransformerConfig, name: str):
    """A port parameter's place in JAX's unboxed tree: (key path, group
    index or None). ``blocks.{i}.<rest>`` is ``blocks/layer_{i %
    group_size}/<rest>`` at ``[i // group_size]``."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return tuple(parts), None
    i = int(parts[1])
    return (("blocks", f"layer_{i % cfg.group_size}", *parts[2:]),
            i // cfg.group_size)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _n_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    return 1


def params_from_jax(cfg: TransformerConfig, tree: dict,
                    device=None) -> Transformer:
    """The port's model holding the values of JAX's unboxed parameter tree
    (nested dicts of numpy arrays, the block leaves stacked by group).
    Every value is copied into the model's own storage."""
    dev = resolve_device(device)
    model = Transformer(cfg, None, "meta").to_empty(device=dev)
    n_blocks = len(model.blocks)
    seen = set()
    for name, p in model.named_parameters():
        path, g = jax_path(cfg, name)
        leaf = _leaf(tree, path)
        seen.add(path)
        val = tensor_from_numpy(leaf if g is None else leaf[g])
        if tuple(val.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX leaf {'/'.join(path)} has shape "
                             f"{tuple(val.shape)}, the port {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(val)
    if len(seen) != _n_leaves(tree):
        raise ValueError(f"the JAX tree has {_n_leaves(tree)} leaves, the "
                         f"port's {cfg.name} model {len(seen)} "
                         f"({n_blocks} blocks)")
    return model


def params_to_numpy(model: Transformer) -> dict:
    """JAX's tree layout (block leaves stacked by group) as numpy arrays;
    bfloat16 values come out as float32 (exact)."""
    cfg = model.cfg
    stacks: dict = {}
    tree: dict = {}
    for name, p in model.named_parameters():
        path, g = jax_path(cfg, name)
        a = p.detach().cpu()
        a = (a.float() if a.dtype == torch.bfloat16 else a).numpy().copy()
        if g is None:
            _set(tree, path, a)
        else:
            stacks.setdefault(path, {})[g] = a
    for path, by_group in stacks.items():
        _set(tree, path, np.stack([by_group[g] for g in sorted(by_group)]))
    return tree


def _set(tree, path, val):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = val
