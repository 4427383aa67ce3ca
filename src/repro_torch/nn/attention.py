"""GQA attention (port of ``repro.nn.attention``): prefill through the
hand-written ``mha`` kernel or the chunked online-softmax scan, KV-cache
decode.

Attention kinds, as in JAX: ``global``, ``local`` (sliding window),
``chunk`` (chunked local), ``global_nope`` (no RoPE); logit softcapping;
optional QK-norm; grouped KV heads (query head ``h`` reads kv head
``h // G``).

Prefill attention takes one of two routes per layer, chosen from the
layer's settings and the tensor's device (``choose_route``), never by
catching an error:

- ``kernel``: on a CUDA tensor, for a causal ``global``/``global_nope``
  layer without softcap, ``S % 128 == 0`` and ``d_head <= 256``. q, k and
  v go to ``[B, H, S, D]`` (k and v expanded to H heads with
  ``repeat_interleave(G)``) and through ``kernels/flash_attention``'s
  ``mha(causal=True)``, the CUDA counterpart of the JAX package's Pallas
  ``flash_attention`` (the same math as JAX's ``attention_scan``). A
  failed build or launch raises; nothing takes the scan route instead.
- ``scan``: ``attention_scan``'s chunked online softmax (the ``-1e30``
  mask, the denominator clamp), which is what JAX runs for every layer.
  Every other layer and every CPU tensor take it.

The kernel route masks by index within the sequence: its positions must
be ``0..S-1`` on every row, as ``prefill`` and ``forward`` give them.
``route_calls`` counts calls per route. Passing ``route="kernel"`` forces
the kernel route where it applies (on a CPU tensor ``mha`` runs its plain
version, ``attention_ref``); that is how the tests hold the wiring.

The kernel has no backward (nor has the JAX package's Pallas kernel: JAX
trains through ``attention_scan``). So ``attend`` raises when the kernel
route is chosen, forced or by default, while autograd records and q, k or
v requires a gradient: the gradient to ``wq``/``wk``/``wv`` would be lost
without an error. Nothing switches routes in silence; the training loss
asks for the scan by name.

Decode writes the new slot into the cache's tensors in place (JAX returns
a new cache; a copy of a full-width cache per step would move more bytes
than the step itself) and returns the cache.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..kernels.flash_attention import flash_attention as fa
from ..kernels.flash_attention.ops import mha
from .layers import Dense, RMSNorm, softcap
from .module import cast_scalar, shard_activation
from .rope import apply_rope

NEG = -1e30
ROUTES = ("kernel", "scan")
KERNEL_KINDS = ("global", "global_nope")
KERNEL_BLOCK = 128  # mha's sequence tile: S must be a multiple

route_calls = dict.fromkeys(ROUTES, 0)


@dataclasses.dataclass(frozen=True)
class AttnSettings:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 1e4
    kind: str = "global"  # global | local | chunk | global_nope
    window: int = 4096  # window size (local) or chunk size (chunk)
    logit_softcap: Optional[float] = None
    qk_norm: bool = False
    chunk_q: int = 512  # kv-chunk for the online-softmax scan
    query_scale: Optional[float] = None  # default 1/sqrt(d_head)


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo`` and, with QK-norm, ``q_norm`` and
    ``k_norm`` (JAX's ``attn_init`` dict)."""

    def __init__(self, s: AttnSettings, generator, dtype=torch.float32,
                 device="cpu"):
        super().__init__()
        d, h, kv, hd = s.d_model, s.n_heads, s.n_kv_heads, s.d_head
        self.wq = Dense((d, h * hd), generator, dtype, device)
        self.wk = Dense((d, kv * hd), generator, dtype, device)
        self.wv = Dense((d, kv * hd), generator, dtype, device)
        self.wo = Dense((h * hd, d), generator, dtype, device,
                        axes=("mlp", "embed"))
        if s.qk_norm:
            self.q_norm = RMSNorm(hd, dtype, device, axes=(None,))
            self.k_norm = RMSNorm(hd, dtype, device, axes=(None,))


def attn_init(generator, s: AttnSettings, dtype=torch.float32,
              device="cpu") -> Attention:
    return Attention(s, generator, dtype, device)


def _qk_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _project_qkv(p: Attention, s: AttnSettings, x, positions):
    b, seq, _ = x.shape
    h, kv, hd = s.n_heads, s.n_kv_heads, s.d_head
    q = (x @ p.wq.kernel).reshape(b, seq, h, hd)
    k = (x @ p.wk.kernel).reshape(b, seq, kv, hd)
    v = (x @ p.wv.kernel).reshape(b, seq, kv, hd)
    if s.qk_norm:
        q = _qk_norm(q, p.q_norm.scale)
        k = _qk_norm(k, p.k_norm.scale)
    if s.kind != "global_nope":
        q = apply_rope(q, positions, s.rope_theta)
        k = apply_rope(k, positions, s.rope_theta)
    return q, k, v


def _mask_logits(s: AttnSettings, qpos, kpos, logits):
    """Softcap, then the causal/local/chunk mask. qpos [..., Sq, 1] and
    kpos [..., 1, Sk] broadcast (ints or int tensors)."""
    if s.logit_softcap is not None:
        logits = softcap(logits, s.logit_softcap)
    ok = kpos <= qpos
    if s.kind == "local":
        ok &= kpos > qpos - s.window
    elif s.kind == "chunk":
        ok &= (kpos // s.window) == (qpos // s.window)
    ok &= kpos >= 0
    return torch.where(ok, logits, NEG)


def _query_scale(s: AttnSettings) -> float:
    return s.query_scale if s.query_scale is not None else s.d_head ** -0.5


def kernel_route_applies(s: AttnSettings, x: torch.Tensor) -> bool:
    """The settings and shape ``mha`` computes exactly: causal global
    attention without softcap, ``S % 128 == 0``, ``d_head <= 256``, in a
    type the kernel takes."""
    return (s.kind in KERNEL_KINDS and s.logit_softcap is None
            and x.shape[1] % KERNEL_BLOCK == 0
            and s.d_head <= fa.MAX_HEAD_DIM and x.dtype in fa.ROUTES)


def choose_route(s: AttnSettings, x: torch.Tensor,
                 route: Optional[str] = None) -> str:
    """``route=None``: ``kernel`` on a CUDA tensor where it applies, else
    ``scan``. A forced ``kernel`` where it does not apply raises."""
    if route is None:
        return ("kernel" if x.device.type == "cuda"
                and kernel_route_applies(s, x) else "scan")
    if route not in ROUTES:
        raise ValueError(f"unknown attention route {route!r}")
    if route == "kernel" and not kernel_route_applies(s, x):
        raise ValueError(
            f"the kernel route does not apply to kind {s.kind!r}, softcap "
            f"{s.logit_softcap}, S {x.shape[1]}, d_head {s.d_head}, "
            f"{x.dtype}")
    return route


def _attend_kernel(s: AttnSettings, q, k, v):
    """[B, S, H|KV, hd] q, k, v -> [B, S, H*hd] through ``mha``."""
    b, seq, h, hd = q.shape
    g = h // s.n_kv_heads
    default = hd ** -0.5
    if s.query_scale is not None and s.query_scale != default:
        q = q * cast_scalar(s.query_scale / default, q.dtype)
    if g > 1:  # query head h reads kv head h // G
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    out = mha(qh, kh, vh, causal=True)  # [B, H, S, hd], q's type
    return out.transpose(1, 2).reshape(b, seq, h * hd)


def _attend_scan(s: AttnSettings, q, k, v, positions):
    """JAX's online softmax over kv chunks: [B, S, H*hd] in q's type.
    Products take their operands in float32: bfloat16 values multiply
    exactly there, as under JAX's ``preferred_element_type=float32``."""
    b, seq, h, hd = q.shape
    kv = s.n_kv_heads
    g = h // kv
    q = q.reshape(b, seq, kv, g, hd) * cast_scalar(_query_scale(s), q.dtype)
    c = min(s.chunk_q, seq)
    if seq % c:
        raise ValueError(f"S={seq} is not a multiple of the chunk {c}")
    qf = q.float()
    qpos = positions[:, :, None, None, None]
    m = torch.full((b, seq, kv, g, 1), NEG, device=q.device)
    l = torch.zeros((b, seq, kv, g, 1), device=q.device)
    acc = torch.zeros((b, seq, kv, g, hd), device=q.device)
    for start in range(0, seq, c):
        kc, vc = k[:, start:start + c], v[:, start:start + c]
        kp = positions[:, None, None, None, start:start + c]
        sc = torch.einsum("bsgnd,bcgd->bsgnc", qf, kc.float())
        sc = _mask_logits(s, qpos, kp, sc)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bsgnc,bcgd->bsgnd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out.reshape(b, seq, h * hd)


def attend_heads(s: AttnSettings, q, k, v, positions,
                 route: Optional[str] = None):
    """Projected q [B, S, H, hd], k and v [B, S, KV, hd] -> the heads'
    outputs [B, S, H*hd] in q's type, through the chosen route (``s``
    gives H, KV and the kind)."""
    route = choose_route(s, q, route)
    if route == "kernel" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the mha kernel route has no backward: train through the scan "
            "route (route='scan', as loss_fn does) or run under "
            "torch.no_grad()")
    route_calls[route] += 1
    if route == "kernel":
        return _attend_kernel(s, q, k, v)
    return _attend_scan(s, q, k, v, positions)


def attend(p: Attention, s: AttnSettings, q, k, v, positions,
           route: Optional[str] = None):
    """Projected q, k, v -> the layer's output [B, S, d] through the
    chosen route, then ``wo``."""
    return attend_heads(s, q, k, v, positions, route) @ p.wo.kernel


def attention(p: Attention, s: AttnSettings, x, positions,
              route: Optional[str] = None):
    """Train/prefill attention: [B, S, d] -> [B, S, d]."""
    q, k, v = _project_qkv(p, s, x, positions)
    return attend(p, s, q, k, v, positions, route)


def attention_scan(p: Attention, s: AttnSettings, x, positions):
    """JAX's ``attention_scan``: the scan route, whatever the device."""
    return attention(p, s, x, positions, route="scan")


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, W, KV, hd]
    v: torch.Tensor  # [B, W, KV, hd]
    slot_pos: torch.Tensor  # [W] int32 absolute position per slot (-1 empty)


def cache_width(s: AttnSettings, max_seq: int) -> int:
    return min(s.window, max_seq) if s.kind in ("local", "chunk") else max_seq


def init_cache(s: AttnSettings, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cpu") -> KVCache:
    w = cache_width(s, max_seq)
    shape = (batch, w, s.n_kv_heads, s.d_head)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        slot_pos=torch.full((w,), -1, dtype=torch.int32, device=device),
    )


def decode_step(p: Attention, s: AttnSettings, x, cache: KVCache, pos: int):
    """One-token decode: x [B, 1, d], ``pos`` an int -> ([B, 1, d], cache
    with slot ``pos % W`` written in place)."""
    b = x.shape[0]
    h, kv, hd = s.n_heads, s.n_kv_heads, s.d_head
    g = h // kv
    w = cache.k.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, s, x, positions)
    slot = pos % w  # ring buffer for local/chunk; plain index for global
    cache.k[:, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.slot_pos[slot] = pos
    k = shard_activation(cache.k, ("batch", "act_model", None, None))
    v = shard_activation(cache.v, ("batch", "act_model", None, None))
    # JAX's einsums "bgnd,bwgd->bgnw" and "bgnw,bwgd->bgnd" with float32
    # accumulation: each cache goes to float32 in the [B, KV, W, hd]
    # layout in one copy, then batched products over (b, g)
    kf, vf = (t.transpose(1, 2).to(torch.float32,
                                   memory_format=torch.contiguous_format)
              for t in (k, v))
    qg = q.reshape(b, kv, g, hd) * cast_scalar(_query_scale(s), q.dtype)
    logits = qg.to(k.dtype).float() @ kf.transpose(-1, -2)  # [B, KV, G, W]
    logits = _mask_logits(s, pos, cache.slot_pos[None, None, None, :],
                          logits)
    probs = torch.softmax(logits, dim=-1)
    out = probs.to(v.dtype).float() @ vf  # [B, KV, G, hd]
    out = out.reshape(b, 1, h * hd).to(x.dtype)
    return out @ p.wo.kernel, cache


def cache_from_kv(s: AttnSettings, k, v, positions, max_seq: int) -> KVCache:
    """The cache ``decode_step`` expects after a prefill of length S, from
    the prefill's projected k and v (global kinds: slots 0..S-1; local and
    chunk kinds: the last W positions at slot ``pos % W``)."""
    b, seq = k.shape[:2]
    w = cache_width(s, max_seq)
    if w >= seq:
        shape = (b, w, *k.shape[2:])
        k_pad = torch.zeros(shape, dtype=k.dtype, device=k.device)
        v_pad = torch.zeros(shape, dtype=v.dtype, device=v.device)
        k_pad[:, :seq] = k
        v_pad[:, :seq] = v
        sp = torch.full((w,), -1, dtype=torch.int32, device=k.device)
        sp[:seq] = positions[0]
        return KVCache(k=k_pad, v=v_pad, slot_pos=sp)
    last_pos = positions[0, seq - w:]
    order = torch.argsort(last_pos % w, stable=True)
    return KVCache(
        k=k[:, seq - w:][:, order],
        v=v[:, seq - w:][:, order],
        slot_pos=last_pos[order].to(torch.int32),
    )


def prefill_kv(p: Attention, s: AttnSettings, x, positions, max_seq: int):
    """JAX's ``prefill_kv``: project, then ``cache_from_kv``."""
    _, k, v = _project_qkv(p, s, x, positions)
    return cache_from_kv(s, k, v, positions, max_seq)
