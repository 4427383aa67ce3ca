"""Config-driven transformer LM family (port of ``repro.models.transformer``):
forward, the training loss and its gradient path, and the serving path
(prefill, decode).

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
and ``params_to_numpy`` carry a model across both ways, ``grads_to_numpy``
its gradients, ``state_to_numpy``/``state_from_jax`` a train state (model
and ``AdamWState``), and ``state_tree`` is that state in JAX's layout
holding the live tensors (what the checkpoint saves and restores in place).

Prefill and forward attention take the route ``nn.attention`` chooses per
layer: the ``mha`` kernel on the card where it applies, the scan
elsewhere. The kernel has no backward, so the training loss takes the scan
route by name, as JAX's ``loss_fn`` calls ``attention_scan``; ``prefill``
and ``decode`` run under ``torch.no_grad()``, so a trained model (whose
parameters require a gradient) serves without building a graph. Decode
attention and every projection stay ``torch.matmul`` / einsum, as JAX
leaves them to XLA. Caches are a list of ``KVCache``, one per layer;
decode writes them in place.

Training: ``loss_fn`` rematerializes each layer per ``cfg.remat`` (JAX's
``none`` / ``dots`` / ``minimal`` / ``full``; every policy but ``none`` is
a per-layer ``torch.utils.checkpoint`` here, which changes memory, not
values) and streams the cross-entropy over ``ce_chunk`` slices, each under
its own checkpoint, so the ``[B, S, vocab]`` float32 logits never exist.
The non-reentrant checkpoint runs its first forward with grad enabled, so
the recompute sees what the forward saw.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..checkpoint.checkpoint import Stacked, snapshot_leaf
from ..kernels.common import init_device, resolve_device, tensor_from_numpy
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
from ..optim.adamw import AdamWState


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
    remat: str = "dots"  # none | dots | minimal | full (training)
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


REMAT_POLICIES = ("none", "dots", "minimal", "full")


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


def init(cfg: TransformerConfig, generator: Optional[torch.Generator],
         device=None) -> Transformer:
    """A model with seeded weights drawn from ``generator`` (on its own
    device) and placed on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``; ``"meta"`` builds the shapes alone, with no generator)."""
    dev = init_device(device)
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


def _remat(fn, *args):
    """``fn(*args)`` under a non-reentrant checkpoint where a graph is
    being built (its activations recomputed in the backward pass)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def hidden_states(params: Transformer, cfg: TransformerConfig, tokens,
                  positions=None, route=None):
    """tokens [B, S] -> (final-norm hidden [B, S, d], total aux loss).
    Caller-given positions keep attention on the scan route unless
    ``route`` says otherwise (the kernel masks by index). Each layer is
    rematerialized unless ``cfg.remat`` is ``none``."""
    b, seq = tokens.shape
    if positions is None:
        positions = _positions(b, seq, tokens.device)
    elif route is None:
        route = "scan"
    if cfg.remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    x = _embed_tokens(params, cfg, tokens)
    aux = torch.zeros((), device=x.device)
    for i, lp in enumerate(params.blocks):
        def layer(x, lp=lp, j=i % cfg.group_size):
            return _layer_apply(lp, cfg, j, x, positions, route)[:2]

        x, a = layer(x) if cfg.remat == "none" else _remat(layer, x)
        aux = aux + a
    return _norm(cfg, params.ln_final, x), aux


def forward(params: Transformer, cfg: TransformerConfig, tokens,
            positions=None, route=None):
    """tokens [B, S] -> (logits [B, S, vocab_padded], total aux loss)."""
    x, aux = hidden_states(params, cfg, tokens, positions, route)
    return _unembed(params, cfg, x), aux


def loss_fn(params: Transformer, cfg: TransformerConfig, batch):
    """batch {"tokens": [B, S], "labels": [B, S]} -> scalar loss.

    Attention takes the scan route by name (JAX's ``attention_scan``; the
    ``mha`` kernel has no backward). Streamed cross-entropy: the logits of
    each ``ce_chunk`` slice are computed under their own checkpoint, so
    the full [B, S, vocab] tensor never exists, forward or backward; the
    slices' log-likelihoods add into one float32 total in order, as JAX's
    scan adds them."""
    x, aux = hidden_states(params, cfg, batch["tokens"], route="scan")
    b, seq, _ = x.shape
    c = min(cfg.ce_chunk, seq)
    if seq % c:
        raise ValueError(f"S={seq} is not a multiple of ce_chunk {c}")
    labels = batch["labels"].long()

    def chunk_ll(x_c, y_c):
        logp = torch.log_softmax(_unembed(params, cfg, x_c), dim=-1)
        return logp.gather(-1, y_c[..., None])[..., 0].sum()

    total = torch.zeros((), device=x.device)
    for start in range(0, seq, c):
        total = total + _remat(chunk_ll, x[:, start:start + c],
                               labels[:, start:start + c])
    return -total / (b * seq) + aux


# --------------------------------------------------------------- serving ---

def init_model_cache(cfg: TransformerConfig, batch: int, max_seq: int,
                     dtype=torch.bfloat16, device=None) -> list:
    dev = init_device(device)  # "meta": the shapes alone
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


@torch.no_grad()
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


@torch.no_grad()
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


def _named_values(cfg: TransformerConfig, model: Transformer, tree: dict):
    """(name, tensor on the CPU) for each port parameter, from JAX's tree
    of numpy arrays laid out like the parameters (block leaves stacked by
    group); checks every shape and that the tree holds no other leaf."""
    seen = set()
    for name, p in model.named_parameters():
        path, g = jax_path(cfg, name)
        leaf = _leaf(tree, path)
        seen.add(path)
        val = tensor_from_numpy(leaf if g is None else leaf[g])
        if tuple(val.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX leaf {'/'.join(path)} has shape "
                             f"{tuple(val.shape)}, the port {tuple(p.shape)}")
        yield name, val
    if len(seen) != _n_leaves(tree):
        raise ValueError(f"the JAX tree has {_n_leaves(tree)} leaves, the "
                         f"port's {cfg.name} model {len(seen)} "
                         f"({len(model.blocks)} blocks)")


def params_from_jax(cfg: TransformerConfig, tree: dict,
                    device=None) -> Transformer:
    """The port's model holding the values of JAX's unboxed parameter tree
    (nested dicts of numpy arrays, the block leaves stacked by group).
    Every value is copied into the model's own storage."""
    dev = resolve_device(device)
    model = Transformer(cfg, None, "meta").to_empty(device=dev)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for name, val in _named_values(cfg, model, tree):
            params[name].copy_(val)
    return model


def named_tree(cfg: TransformerConfig, named: dict) -> dict:
    """JAX's tree layout of ``named`` (port parameter name -> tensor),
    holding the same tensors: block leaves as ``Stacked`` in group
    order."""
    stacks: dict = {}
    tree: dict = {}
    for name, t in named.items():
        path, g = jax_path(cfg, name)
        if g is None:
            _set(tree, path, t)
        else:
            stacks.setdefault(path, {})[g] = t
    for path, by_group in stacks.items():
        _set(tree, path, Stacked(by_group[g] for g in sorted(by_group)))
    return tree


def state_tree(model: Transformer, opt: AdamWState) -> dict:
    """The train state in JAX's layout, ``{"params", "opt": AdamWState(
    step, mu, nu)}``, holding the model's and the optimizer's own tensors:
    the tree ``CheckpointManager`` saves (the keys JAX's train state has)
    and restores in place."""
    cfg = model.cfg
    return {"params": named_tree(cfg, dict(model.named_parameters())),
            "opt": AdamWState(opt.step, named_tree(cfg, opt.mu),
                              named_tree(cfg, opt.nu))}


def _numpy_leaf(leaf) -> np.ndarray:
    arr, dtype = snapshot_leaf(leaf)
    if dtype == "bfloat16":  # exact in float32
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return _numpy_leaf(tree)


def params_to_numpy(model: Transformer) -> dict:
    """JAX's tree layout (block leaves stacked by group) as numpy arrays;
    bfloat16 values come out as float32 (exact)."""
    return _numpy_tree(named_tree(model.cfg, dict(model.named_parameters())))


def grads_to_numpy(model: Transformer) -> dict:
    """The parameters' gradients in JAX's tree layout, as numpy arrays
    (bfloat16 as float32); a parameter without one holds zeros, as
    JAX's gradient of an unused leaf does."""
    return _numpy_tree(named_tree(model.cfg, {
        name: p.grad if p.grad is not None else torch.zeros_like(p)
        for name, p in model.named_parameters()}))


def state_to_numpy(model: Transformer, opt: AdamWState) -> dict:
    """``state_tree`` as numpy arrays (bfloat16 as float32):
    ``{"params", "opt": AdamWState(step, mu, nu)}``."""
    tree = state_tree(model, opt)
    o = tree["opt"]
    return {"params": _numpy_tree(tree["params"]),
            "opt": AdamWState(_numpy_leaf(o.step), _numpy_tree(o.mu),
                              _numpy_tree(o.nu))}


def state_from_jax(cfg: TransformerConfig, tree: dict, device=None):
    """(model, AdamWState) holding JAX's train state ``{"params", "opt":
    (step, mu, nu)}`` (numpy leaves, blocks stacked by group). The model's
    parameters require a gradient; the moments keep their stored dtype;
    the step count is a 0-d int32 CPU tensor."""
    model = params_from_jax(cfg, tree["params"], device)
    model.requires_grad_(True)
    step, mu, nu = tree["opt"]
    dev = next(model.parameters()).device

    def moments(t):
        return {name: val.to(dev, copy=True)
                for name, val in _named_values(cfg, model, t)}

    return model, AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32),
        mu=moments(mu), nu=moments(nu))


def _set(tree, path, val):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = val
