"""The LM (dense and MoE) on a mesh of ranks: ``prefill``, ``decode`` and the
training loss (``loss_fn``) of ``models.transformer`` over each rank's
blocks of the parameters, under the logical-axis rules (``nn.module``).

JAX runs these as one GSPMD program; the port runs one process a rank
with explicit collectives (``core.collectives``, through ``Wire``). A
rank holds the blocks ``nn.module.shard_params`` cut, and the rules and
its ``Mesh`` installed by ``nn.module.set_activation_rules``. With
``D`` the data axes (``rules["embed"]``) and ``M`` the ``model`` axis:

- **FSDP.** A dim with the ``embed`` axis is stored sharded over ``D``.
  Before a layer runs, its blocks are all-gathered over ``D`` in one
  buffer (one layer at a time; the table and the final norm once a
  call). Dims with ``mlp`` or ``vocab`` stay sharded over ``M``.
- **Vocab-parallel embedding and logits.** Each rank looks up the ids
  its rows of the table hold (the others give zeros) and the partials
  are summed over ``M``; the logits of a rank are its vocab columns, the
  ``-1e30`` padding only on the ranks that own padded columns.
- **Column-parallel** ``wq``, ``wk``, ``wv``, ``wi``; **row-parallel**
  ``wo`` (attention and MLP), whose partial sums the layer reduces
  itself. A ``wk``/``wv`` left replicated by ``sanitize_spec`` (a GQA
  ``KV * d_head`` that does not divide ``M``) is used whole. ``wi`` is
  ``[gate | up]`` cut in column blocks, so a rank's block does not hold
  a matching gate and up: the rank's hidden units ``[m F/M, (m+1) F/M)``
  come from an all-gather over ``M`` of the weight block when the call
  has at least ``d_model`` tokens, else of the product ``x @ wi``
  (whichever moves fewer bytes).
- **Prefill (sequence parallel, JAX's SP path of ``_layer_apply``).** The
  residual stream is ``("batch", "res_seq", None)``: batch over ``D``,
  sequence over ``M``. Each norm runs on the sequence block and its
  output (in the model's type) is all-gathered over ``M``; q, k and v
  are column-parallel over the full sequence; k and v are gathered to
  all kv heads (for the cache). Attention is head-parallel: each rank
  attends its ``H / M`` query heads over the full sequence through
  ``nn.attention.attend_heads`` (``mha`` on the card where it applies),
  and the row-parallel outputs are reduce-scattered over the sequence
  on ``M`` (``core.collectives.psum_scatter``). JAX's GSPMD moves q to
  the sequence-sharded layout instead; the function is the same.
- **Training (``loss_fn``, the SP layer of the prefill under autograd).**
  Every collective of the forward carries a gradient
  (``core.collectives``): an all-gather's backward reduce-scatters the
  sum, a reduce-scatter's gathers the blocks, so a block's FSDP gradient
  is reduce-scattered over ``D`` and the vocab-parallel embedding's
  over ``M``. Attention takes the scan route by name. Each layer runs
  under a per-layer non-reentrant checkpoint (``cfg.remat``), its FSDP
  gather inside it, and the recompute runs to the layer's end, so it
  sends the layer's forward collectives again, in the same order on
  every rank. The cross-entropy streams over ``ce_chunk`` slices of
  the final norm's output gathered over ``M``, each checkpointed: a
  rank's vocab columns of the logits, the log-sum-exp from a max
  all-reduced without a gradient and the exponentials' sums added over
  ``M``, the label's logit taken from the rank that owns its column and
  added over ``M``. A rank's loss is a share: its rows' negative
  log-likelihood over the global token count and over the ``M`` ranks
  that compute the same rows, so the shares add up to JAX's mean.
- **Decode (tensor parallel).** The residual stream is replicated over
  ``M``. Each layer's cache is ``[B, W, KV, hd]``, the batch over ``D``
  (or replicated when the batch does not divide ``D``) and ``W`` over
  ``seq_axes``; only the rank that owns slot ``pos % W`` writes the new
  k, v and ``slot_pos``. q, k and v are gathered to all heads; each rank
  scores its slots, and the ranks of ``seq_axes`` combine them
  flash-decoding style: an all-reduce of the max, then sums of the
  exponentials and of the weighted values (``psum``), which feed the
  row-parallel ``wo``.
- **MoE (expert parallel over ``model``).** Every token of a data block
  is already on every ``model`` rank before the FFN (the gathered norm
  output under SP, the replicated residual in decode), so each rank
  routes the same tokens and runs only its ``E / M`` experts; the
  combine is the row-parallel reduce over ``model`` the dense FFN ends
  with, and no token is exchanged. JAX's GSPMD moves tokens by an
  all-to-all at dispatch and at combine instead; the function is the
  same because routing stays global: the capacity comes from the
  call's global token count, and a slot's position in its expert is
  the count over all slots of the call in global token-major order
  (each rank's local count offset by the expert counts of the data
  blocks before it, all-gathered over the batch axes). The aux loss is
  JAX's product of two global means, from the router probabilities'
  sums (``psum_grad`` over the batch axes) and the top-1 counts.

Float sums across ranks fold in coordinate order, so a run gives the
same bits under gloo and NCCL. ``collective_schedule`` is the analytic
count of what these functions send, by kind (a train step's with
``launch.steps``' gradient sums): the dry-run's wire term, held against
``Wire``'s records in the tests.
"""
from __future__ import annotations

import dataclasses
import math
import types

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import set_checkpoint_early_stop

from ..core.collectives import (
    gather_rows,
    gather_rows_grad,
    max_allreduce,
    psum,
    psum_grad,
    psum_scatter_grad,
)
from ..nn.attention import (
    KVCache,
    _mask_logits,
    _qk_norm,
    _query_scale,
    attend_heads,
    cache_from_kv,
    cache_width,
)
from ..nn.layers import rmsnorm, softcap
from ..nn.module import (
    activation_rules,
    block_slices,
    cast_scalar,
    part_axes,
    shard_activation,
)
from ..nn.rope import apply_rope
from .transformer import REMAT_POLICIES, _remat as _layer_remat

RES_SP = ("batch", "res_seq", None)  # the prefill's residual stream
FULL_SEQ = ("batch", None, None)  # a norm's output, gathered
#: when a list, each MoE layer of a ``prefill``/``decode`` call appends
#: its routing on this rank: ``{"layer", "experts" [t, K], "keep" [t*K]
#: (token-major), "kept", "slots", "capacity"}`` on the host, and each
#: ``loss_fn`` call its layers' aux sum (``{"aux"}``); None records
#: nothing (and syncs nothing)
moe_log = None


@dataclasses.dataclass
class _Ctx:
    """One call's view of the rank: mesh, rules, blocks and specs."""

    cfg: object
    mesh: object
    rules: dict
    params: dict
    specs: dict
    data: tuple  # FSDP axes of size > 1
    m: int  # size of "model"
    mi: int  # this rank's "model" coordinate
    layer_w: dict | None = None  # the running layer's gathered weights

    def model_axes(self):
        return self.mesh.axes(("model",))

    def batch_axes(self):
        """The axes that split the batch (the rules' ``batch``; none
        where the run keeps it replicated)."""
        return self.mesh.axes(tuple(a for a in self.rules["batch"]
                                    if self.mesh.shape.get(a, 1) > 1))

    def m_sharded(self, name: str, dim: int) -> bool:
        return self.m > 1 and "model" in part_axes(self.specs[name][dim])


def _ctx(model, cfg) -> _Ctx:
    rules, mesh = activation_rules()
    if rules is None or mesh is None:
        raise RuntimeError("the mesh path needs the rules and the rank's "
                           "Mesh installed (nn.module.set_activation_rules)")
    specs = getattr(model, "shard_specs", None)
    if specs is None:
        raise ValueError("cut the model to this rank's blocks first "
                         "(nn.module.shard_params)")
    m = mesh.shape.get("model", 1)
    if cfg.n_heads % m or cfg.d_ff % m:
        raise ValueError(f"{cfg.n_heads} heads and d_ff {cfg.d_ff} must "
                         f"split over the model axis ({m}): attention is "
                         "head-parallel")
    mo = cfg.moe
    if mo is not None and (mo.n_experts % m or (mo.d_ff * mo.n_shared) % m):
        raise ValueError(f"{mo.n_experts} experts and a shared expert of "
                         f"{mo.d_ff * mo.n_shared} must split over the "
                         f"model axis ({m}): the experts are "
                         "expert-parallel")
    data = tuple(a for a in rules["embed"] if mesh.shape.get(a, 1) > 1)
    return _Ctx(cfg, mesh, rules, dict(model.named_parameters()), specs,
                data, m, mesh.coord("model") if m > 1 else 0)


def _gather(ctx: _Ctx, names) -> dict:
    """The named blocks all-gathered over the data axes (FSDP) where
    their spec shards a dim there, in one buffer (its gradient
    reduce-scattered back); ``model`` sharding stays."""
    out, pending = {}, []
    for n in names:
        dims = [i for i, part in enumerate(ctx.specs[n])
                if set(part_axes(part)) & set(ctx.data)]
        if not dims:
            out[n] = ctx.params[n]
            continue
        (dim,) = dims
        if tuple(a for a in part_axes(ctx.specs[n][dim])
                 if ctx.mesh.shape.get(a, 1) > 1) != ctx.data:
            raise ValueError(f"{n}: {ctx.specs[n]} mixes the data axes "
                             "with others")
        pending.append((n, dim))
    if pending:
        flat = torch.cat([ctx.params[n].reshape(-1) for n, _ in pending])
        g = gather_rows_grad(flat[None], ctx.mesh.axes(ctx.data), 0)
        off = 0
        for n, dim in pending:
            blk = ctx.params[n]
            parts = g[:, off:off + blk.numel()].reshape(g.shape[0],
                                                         *blk.shape)
            out[n] = torch.cat(list(parts.unbind(0)), dim=dim)
            off += blk.numel()
    return out


def _norm(cfg, scale, x):
    return rmsnorm(types.SimpleNamespace(scale=scale), x, cfg.norm_eps,
                   cfg.zero_centered_norm)


def _residual(cfg, x, h):
    return x + h * cast_scalar(cfg.residual_scale, h.dtype)


def _table_name(cfg) -> str:
    return "embed.table" if cfg.tie_embeddings else "unembed.table"


def _globals(ctx: _Ctx) -> dict:
    names = ["embed.table", "ln_final.scale"]
    if not ctx.cfg.tie_embeddings:
        names.append("unembed.table")
    return _gather(ctx, names)


def _embed(ctx: _Ctx, g: dict, tokens, sp: bool):
    """Vocab-parallel lookup, summed over ``model``: ``[b, S/M, d]``
    (``sp``) or ``[b, S, d]`` replicated over ``model``."""
    table = g["embed.table"]
    if ctx.m_sharded("embed.table", 0):
        n = table.shape[0]
        loc = tokens - ctx.mi * n
        ok = (loc >= 0) & (loc < n)
        x = table[loc.clamp(0, n - 1)] * ok[..., None].to(table.dtype)
        x = (psum_scatter_grad(x, ctx.model_axes(), dim=1) if sp
             else psum(x, ctx.model_axes()))
    else:
        x = table[tokens]
        if sp:
            x = shard_activation(x, RES_SP, have=FULL_SEQ)
    if ctx.cfg.emb_scale is not None:
        x = x * cast_scalar(ctx.cfg.emb_scale, x.dtype)
    return x


def _unembed(ctx: _Ctx, g: dict, x):
    """This rank's vocab columns of the logits (float32)."""
    cfg, name = ctx.cfg, _table_name(ctx.cfg)
    table = g[name]
    logits = (x @ table.T).float() * cfg.logit_scale
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    if cfg.vocab_padded != cfg.vocab:  # only the columns this rank owns
        lo = ctx.mi * table.shape[0] if ctx.m_sharded(name, 0) else 0
        col = torch.arange(lo, lo + table.shape[0], device=logits.device)
        logits = logits.masked_fill(col >= cfg.vocab, -1e30)
    return logits


def _cols(ctx: _Ctx, y, name: str):
    """A column-parallel product gathered to all its columns."""
    if ctx.m_sharded(name, 1):
        return gather_rows_grad(y, ctx.model_axes(), y.dim() - 1)
    return y


def _project(ctx: _Ctx, s, w: dict, pre: str, h, positions, all_q: bool):
    """q (this rank's heads, or all with ``all_q``), k and v (all kv
    heads) of ``h`` [b, S, d], QK-normed and rotated."""
    b, seq, _ = h.shape
    hd = s.d_head
    q = h @ w[pre + "wq.kernel"]
    if all_q:
        q = _cols(ctx, q, pre + "wq.kernel")
    k = _cols(ctx, h @ w[pre + "wk.kernel"], pre + "wk.kernel")
    v = _cols(ctx, h @ w[pre + "wv.kernel"], pre + "wv.kernel")
    q = q.reshape(b, seq, -1, hd)
    k = k.reshape(b, seq, s.n_kv_heads, hd)
    v = v.reshape(b, seq, s.n_kv_heads, hd)
    if s.qk_norm:
        q = _qk_norm(q, w[pre + "q_norm.scale"])
        k = _qk_norm(k, w[pre + "k_norm.scale"])
    if s.kind != "global_nope":
        q = apply_rope(q, positions, s.rope_theta)
        k = apply_rope(k, positions, s.rope_theta)
    return q, k, v


def _heads(ctx: _Ctx) -> tuple:
    """This rank's query heads ``[q0, q0 + n)``."""
    n = ctx.cfg.n_heads // ctx.m
    return ctx.mi * n, n


def _rank_kv(ctx: _Ctx, s, k, v):
    """Settings, k and v for this rank's query heads: the kv heads they
    read (whole groups), or one kv head a query head where the rank's
    heads split a group."""
    if ctx.m == 1:
        return s, k, v
    q0, n = _heads(ctx)
    g = s.n_heads // s.n_kv_heads
    if n % g == 0:
        a = q0 // g
        return (dataclasses.replace(s, n_heads=n, n_kv_heads=n // g),
                k[:, :, a:a + n // g], v[:, :, a:a + n // g])
    idx = torch.arange(q0, q0 + n, device=k.device) // g
    return (dataclasses.replace(s, n_heads=n, n_kv_heads=n),
            k[:, :, idx], v[:, :, idx])


def _reduce(ctx: _Ctx, out, sp: bool):
    """Partial sums reduced over ``model``: reduce-scattered over the
    sequence (``sp``) or summed."""
    if ctx.m == 1:
        return out
    if sp:
        return psum_scatter_grad(out, ctx.model_axes(), dim=1)
    return psum(out, ctx.model_axes())


def _row_parallel(ctx: _Ctx, y, name: str, sp: bool):
    """``y`` (this rank's rows of ``name``) times its block, the partial
    sums reduced over ``model``."""
    return _reduce(ctx, y @ ctx.layer_w[name], sp)


def _ffn_partial(ctx: _Ctx, pre: str, x, f: int):
    """SwiGLU of width ``f`` over this rank's hidden units: this rank's
    partial sum of the row-parallel ``wo`` (unreduced)."""
    wi = ctx.layer_w[pre + "wi.kernel"]
    if ctx.m == 1:
        gu = x @ wi
        g, u = torch.chunk(gu, 2, dim=-1)
    else:  # _ctx checked that the width splits over "model"
        n = f // ctx.m
        lo = ctx.mi * n
        if x.numel() // x.shape[-1] < ctx.cfg.d_model:  # pair the products
            gu = gather_rows_grad(x @ wi, ctx.model_axes(), x.dim() - 1)
            g, u = gu[..., lo:lo + n], gu[..., f + lo:f + lo + n]
        else:  # pair the weight's columns
            full = gather_rows_grad(wi, ctx.model_axes(), 1)
            gu = x @ torch.cat([full[:, lo:lo + n],
                                full[:, f + lo:f + lo + n]], dim=1)
            g, u = torch.chunk(gu, 2, dim=-1)
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ ctx.layer_w[pre + "wo.kernel"]


def _ffn(ctx: _Ctx, pre: str, x, sp: bool):
    """SwiGLU over this rank's hidden units, row-parallel ``wo``."""
    return _reduce(ctx, _ffn_partial(ctx, pre, x, ctx.cfg.d_ff), sp)


def _moe(ctx: _Ctx, i: int, pre: str, x, sp: bool, with_aux: bool):
    """``nn.moe.moe`` over this rank's ``E / M`` experts on ``x`` [b, S,
    d] (every token of the rank's data block, the same on every
    ``model`` rank) -> (the output reduced over ``model`` as
    ``_reduce``'s, the layer's aux loss or None). Capacity and slot
    positions are JAX's global ones (the module docstring); a slot
    kept on another rank's expert adds zero here."""
    mo, w = ctx.cfg.moe, ctx.layer_w
    b, seq, d = x.shape
    t, e_all, k = b * seq, mo.n_experts, mo.top_k
    xt = x.reshape(t, d)
    probs = torch.softmax((xt @ w[pre + "router.kernel"]).float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :k], idx[:, :k]  # ties to the lower expert
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    batch = ctx.batch_axes()
    t_all = t * batch.size  # the call's tokens: C is nn.moe.moe's of them
    dropless = t_all * k <= mo.dropless_threshold
    cap = (t_all * k if dropless
           else max(int(mo.capacity_factor * t_all * k / e_all), 1))
    e_flat = idx.reshape(t * k)  # token-major
    pos = (torch.cumsum(F.one_hot(e_flat, e_all), dim=0) - 1).gather(
        1, e_flat[:, None])[:, 0]  # the slot's place among this block's
    counts = []  # [n, E] integers: all slots (kept or not), top-1 picks
    if not dropless:
        counts.append(torch.bincount(e_flat, minlength=e_all))
    if with_aux:
        counts.append(torch.bincount(idx[:, 0], minlength=e_all))
    if counts:  # every data block's, in flat-coordinate order
        every = gather_rows(torch.stack(counts)[None], batch, 0)
    keep = torch.ones_like(pos, dtype=torch.bool)
    if not dropless:  # the data blocks before this one come first
        keep = pos + every[:batch.index(), 0].sum(0)[e_flat] < cap
    # this rank's experts: one buffer row a kept slot, at the slot's place
    # among this block's (a prefix of the expert's kept places)
    e_loc = e_all // ctx.m
    lo = ctx.mi * e_loc
    rows = min(cap, t * k)
    mine = keep & (e_flat >= lo) & (e_flat < lo + e_loc)
    trash = e_loc * rows  # a zero row: another rank's slot or a dropped one
    dst = torch.where(mine, (e_flat - lo) * rows + pos, trash)
    src = torch.full((trash + 1,), t, dtype=torch.long, device=x.device)
    src[dst] = torch.arange(t * k, device=x.device) // k
    src[trash] = t
    xz = torch.cat([xt, xt.new_zeros(1, d)])
    buf = xz[src[:trash]].reshape(e_loc, rows, d)
    gu = torch.bmm(buf, w[pre + "experts.wi.kernel"])
    g, u = torch.chunk(gu, 2, dim=-1)
    h = F.silu(g) * u  # in the compute dtype, as in JAX
    out = torch.bmm(h, w[pre + "experts.wo.kernel"]).reshape(trash, d)
    out = torch.cat([out, out.new_zeros(1, d)])
    y = (out[dst] * gates.reshape(t * k)[:, None].to(x.dtype)).reshape(
        t, k, d).sum(dim=1).reshape(b, seq, d)
    if mo.n_shared:
        y = y + _ffn_partial(ctx, pre + "shared.", x, mo.d_ff * mo.n_shared)
    aux = None
    if with_aux:  # JAX's: E w sum_e mean(probs)_e mean(top-1)_e, global
        me = psum_grad(probs.sum(dim=0), batch) / t_all
        ce = every[:, -1].sum(0).float() / t_all
        aux = (me * ce).sum() * e_all * mo.router_aux_weight
    if moe_log is not None and not torch.is_grad_enabled():
        moe_log.append({"layer": i, "experts": idx.cpu().numpy(),
                        "keep": keep.cpu().numpy(),
                        "kept": int(keep.sum()), "slots": t * k,
                        "capacity": cap})
    return _reduce(ctx, y, sp), aux


def _layer_weights(ctx: _Ctx, i: int) -> str:
    pre = f"blocks.{i}."
    ctx.layer_w = _gather(ctx, [n for n in ctx.params
                                if n.startswith(pre)])
    return pre


def _seq_block(ctx: _Ctx, cache: KVCache, seq_axes) -> KVCache:
    """This rank's slots of a whole cache (``W`` over ``seq_axes``)."""
    mesh = ctx.mesh
    coords = {a: mesh.coord(a) for a in mesh.axis_names}
    (sl,) = block_slices(cache.slot_pos.shape, (tuple(seq_axes),),
                         mesh.shape, coords)
    return KVCache(k=cache.k[:, sl].contiguous(),
                   v=cache.v[:, sl].contiguous(),
                   slot_pos=cache.slot_pos[sl].contiguous())


def _layer_sp(ctx: _Ctx, i: int, x, positions, route, max_seq=None,
              seq_axes=None):
    """One sequence-parallel layer on ``x`` [b, S/M, d] -> (x, this
    rank's block of the layer's cache, or None without ``max_seq``: the
    training forward, the layer's MoE aux loss, or None)."""
    cfg = ctx.cfg
    s = cfg.attn_settings(cfg.layer_kind(i % cfg.group_size))
    pre = _layer_weights(ctx, i)
    w = ctx.layer_w
    h_in = shard_activation(_norm(cfg, w[pre + "ln_attn.scale"], x),
                            FULL_SEQ, have=RES_SP)
    q, k, v = _project(ctx, s, w, pre + "attn.", h_in, positions, False)
    cache = None if max_seq is None else _seq_block(
        ctx, cache_from_kv(s, k, v, positions, max_seq), seq_axes)
    s_loc, k, v = _rank_kv(ctx, s, k, v)
    out = attend_heads(s_loc, q, k, v, positions, route)
    del q, k, v
    h = _row_parallel(ctx, out, pre + "attn.wo.kernel", sp=True)
    if cfg.use_post_norm:
        h = _norm(cfg, w[pre + "ln_attn_post.scale"], h)
    x = _residual(cfg, x, h)
    m_in = shard_activation(_norm(cfg, w[pre + "ln_mlp.scale"], x),
                            FULL_SEQ, have=RES_SP)
    aux = None
    if cfg.layer_is_moe(i % cfg.group_size):
        h, aux = _moe(ctx, i, pre + "moe.", m_in, True, max_seq is None)
    else:
        h = _ffn(ctx, pre + "mlp.", m_in, sp=True)
    if cfg.use_post_norm:
        h = _norm(cfg, w[pre + "ln_mlp_post.scale"], h)
    ctx.layer_w = None
    return _residual(cfg, x, h), cache, aux


def decode_seq_axes(batch: int, mesh_shape: dict, batch_axes: tuple):
    """JAX's decode cache layout: (``W``'s axes, the batch's axes or
    None). The batch goes over the data axes when it divides them; else
    the cache sequence goes over every axis (``long_500k``, B 1)."""
    data = int(math.prod(mesh_shape.get(a, 1) for a in batch_axes))
    if batch >= data and batch % data == 0:
        return ("model",), tuple(batch_axes)
    return tuple(batch_axes) + ("model",), None


@torch.no_grad()
def prefill(model, cfg, tokens, max_seq=None, route=None,
            seq_axes=("model",)):
    """This rank's block of ``tokens`` [b, S] (batch over the data axes,
    or the whole batch when it is replicated) -> (this rank's vocab
    columns of the last-position logits [b, V/M] float32, one cache a
    layer in the decode layout: ``W`` over ``seq_axes``)."""
    ctx = _ctx(model, cfg)
    b, seq = tokens.shape
    if seq % ctx.m:
        raise ValueError(f"S={seq} does not split over the model axis")
    max_seq = max_seq or seq
    positions = torch.arange(seq, dtype=torch.int32,
                             device=tokens.device).expand(b, seq)
    g = _globals(ctx)
    x = _embed(ctx, g, tokens, sp=True)
    caches = []
    for i in range(len(model.blocks)):
        x, c, _ = _layer_sp(ctx, i, x, positions, route, max_seq, seq_axes)
        caches.append(c)
    # position S-1 is on the last model coordinate (the norm runs over
    # the rank's block, as transformer.prefill's over the whole)
    last = _norm(cfg, g["ln_final.scale"], x)[:, -1:]
    if ctx.m > 1:
        last = gather_rows(last, ctx.model_axes(), 0)[-b:]
    return _unembed(ctx, g, last)[:, 0], caches


def _remat(fn, *args):
    """``transformer._remat`` with the recompute run to the function's
    end: PyTorch otherwise stops it at the last saved tensor, before a
    layer's closing reduce-scatter, so the ranks' calls would depend on
    what each op saves."""
    with set_checkpoint_early_stop(False):
        return _layer_remat(fn, *args)


def _chunk_ll(ctx: _Ctx, g: dict, x, labels):
    """The log-likelihood sum of one cross-entropy chunk (``x`` [b, c,
    d], the whole sequence's slice; ``labels`` [b, c]) over this rank's
    vocab columns, as ``jax.nn.log_softmax`` takes it: the logits
    shifted by their max (all-reduced over ``model``, no gradient),
    the shifted label logit (from the rank that owns its column) less
    the log of the shifted exponentials' sum, both sums over
    ``model``."""
    logits = _unembed(ctx, g, x)
    n = logits.shape[-1]
    sharded = ctx.m_sharded(_table_name(ctx.cfg), 0)
    axes = ctx.model_axes() if sharded else ()
    shifted = logits - max_allreduce(
        logits.detach().amax(dim=-1, keepdim=True), axes)
    loc = labels - (ctx.mi * n if sharded else 0)
    own = (loc >= 0) & (loc < n)
    lab = shifted.gather(-1, loc.clamp(0, n - 1)[..., None])[..., 0]
    sums = psum_grad(torch.stack([shifted.exp().sum(dim=-1),
                                  torch.where(own, lab, 0.0)]), axes)
    return (sums[1] - torch.log(sums[0])).sum()


def loss_fn(model, cfg, batch):
    """This rank's share of ``transformer.loss_fn``: ``batch``
    {"tokens", "labels"} holds the rank's rows [b, S] (the batch over
    the rules' ``batch`` axes, or whole where those are empty) -> a
    scalar whose sum over the ranks is the global loss (the rank's
    negative log-likelihood over the global token count and over the
    ranks that compute the same rows). Backward through it leaves each
    parameter block the rank's share of its gradient, summed over the
    axes its spec shards (``launch.steps._mesh_update`` sums the
    rest)."""
    ctx = _ctx(model, cfg)
    tokens, labels = batch["tokens"], batch["labels"].long()
    b, seq = tokens.shape
    if seq % ctx.m:
        raise ValueError(f"S={seq} does not split over the model axis")
    c = min(cfg.ce_chunk, seq)
    if seq % c:
        raise ValueError(f"S={seq} is not a multiple of ce_chunk {c}")
    if cfg.remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    positions = torch.arange(seq, dtype=torch.int32,
                             device=tokens.device).expand(b, seq)
    g = _globals(ctx)
    x = _embed(ctx, g, tokens, sp=True)
    aux = torch.zeros((), device=x.device)
    for i in range(len(model.blocks)):
        def layer(x, i=i):
            x, _, a = _layer_sp(ctx, i, x, positions, "scan")
            return x, (torch.zeros((), device=x.device) if a is None else a)

        x, a = layer(x) if cfg.remat == "none" else _remat(layer, x)
        aux = aux + a
    if moe_log is not None and cfg.moe is not None:
        moe_log.append({"aux": float(aux.detach())})
    x = shard_activation(_norm(cfg, g["ln_final.scale"], x), FULL_SEQ,
                         have=RES_SP)
    total = torch.zeros((), device=x.device)
    for start in range(0, seq, c):
        total = total + _remat(_chunk_ll, ctx, g, x[:, start:start + c],
                               labels[:, start:start + c])
    rows = math.prod(ctx.mesh.shape.get(a, 1) for a in ctx.rules["batch"])
    # the aux is global on every rank: each adds its share of it
    return (-total / (b * rows * seq) / (ctx.mesh.size // rows)
            + aux / ctx.mesh.size)


def init_cache(cfg, batch: int, max_seq: int, mesh, seq_axes,
               dtype=torch.bfloat16, device=None) -> list:
    """Empty cache blocks of this rank (``batch``: its rows)."""
    dev = device or mesh.device
    k = int(math.prod(mesh.shape.get(a, 1) for a in seq_axes))
    out = []
    for i in range(cfg.n_layers):
        s = cfg.attn_settings(cfg.layer_kind(i))
        w = cache_width(s, max_seq)
        if w % k:
            raise ValueError(f"a cache of {w} slots does not split over "
                             f"{seq_axes}")
        shape = (batch, w // k, s.n_kv_heads, s.d_head)
        out.append(KVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            slot_pos=torch.full((w // k,), -1, dtype=torch.int32,
                                device=dev)))
    return out


def _layer_decode(ctx: _Ctx, i: int, x, cache: KVCache, pos: int,
                  seq_axes):
    cfg, mesh = ctx.cfg, ctx.mesh
    s = cfg.attn_settings(cfg.layer_kind(i % cfg.group_size))
    pre = _layer_weights(ctx, i)
    w = ctx.layer_w
    b = x.shape[0]
    h, kv, hd = s.n_heads, s.n_kv_heads, s.d_head
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project(ctx, s, w, pre + "attn.",
                               _norm(cfg, w[pre + "ln_attn.scale"], x),
                               positions, True)
    sa = mesh.axes(tuple(seq_axes))
    w_loc = cache.k.shape[1]
    slot = pos % (w_loc * sa.size)
    if slot // w_loc == sa.index():  # this rank owns the slot
        local = slot - sa.index() * w_loc
        cache.k[:, local] = k_new[:, 0].to(cache.k.dtype)
        cache.v[:, local] = v_new[:, 0].to(cache.v.dtype)
        cache.slot_pos[local] = pos
    kf, vf = (t.transpose(1, 2).to(torch.float32,
                                   memory_format=torch.contiguous_format)
              for t in (cache.k, cache.v))
    qg = q.reshape(b, kv, h // kv, hd) * cast_scalar(_query_scale(s),
                                                    q.dtype)
    logits = qg.to(cache.k.dtype).float() @ kf.transpose(-1, -2)
    logits = _mask_logits(s, pos, cache.slot_pos[None, None, None, :],
                          logits)
    if sa.size == 1:  # every slot here: transformer.decode's softmax
        probs = torch.softmax(logits, dim=-1)
    else:  # flash-decoding combine over the ranks holding the slots
        mx = max_allreduce(logits.amax(dim=-1, keepdim=True), sa)
        e = torch.exp(logits - mx)
        probs = e / psum(e.sum(dim=-1, keepdim=True), sa)
    out = psum(probs.to(cache.v.dtype).float() @ vf, sa)
    out = out.reshape(b, 1, h * hd).to(x.dtype)
    q0, n = _heads(ctx)
    hh = _row_parallel(ctx, out[..., q0 * hd:(q0 + n) * hd],
                       pre + "attn.wo.kernel", sp=False)
    if cfg.use_post_norm:
        hh = _norm(cfg, w[pre + "ln_attn_post.scale"], hh)
    x = _residual(cfg, x, hh)
    m_in = _norm(cfg, w[pre + "ln_mlp.scale"], x)
    if cfg.layer_is_moe(i % cfg.group_size):
        hh, _ = _moe(ctx, i, pre + "moe.", m_in, False, False)
    else:
        hh = _ffn(ctx, pre + "mlp.", m_in, sp=False)
    if cfg.use_post_norm:
        hh = _norm(cfg, w[pre + "ln_mlp_post.scale"], hh)
    ctx.layer_w = None
    return _residual(cfg, x, hh), cache


@torch.no_grad()
def decode(model, cfg, caches, tokens, pos: int, seq_axes=("model",)):
    """One decode step on this rank: ``tokens`` [b, 1] (its batch block),
    ``pos`` an int -> (this rank's vocab columns of the logits [b, 1,
    V/M] float32, the caches, written in place where this rank owns slot
    ``pos % W``)."""
    ctx = _ctx(model, cfg)
    g = _globals(ctx)
    x = _embed(ctx, g, tokens, sp=False)
    for i in range(len(model.blocks)):
        x, caches[i] = _layer_decode(ctx, i, x, caches[i], pos, seq_axes)
    x = _norm(cfg, g["ln_final.scale"], x)
    return _unembed(ctx, g, x), caches


# ------------------------------------------------ the analytic schedule ----

def block_numel(shape, spec, mesh_shape) -> int:
    """Elements of one device's block of a ``shape`` tensor under
    ``spec``."""
    k = int(math.prod(math.prod(mesh_shape.get(a, 1) for a in part_axes(p))
                      for p in spec))
    return int(math.prod(shape)) // k


def _add(recs: dict, kind: str, group: int, nbytes: float,
         calls: int = 1) -> None:
    if group > 1:
        r = recs.setdefault(kind, {}).setdefault(int(group), [0, 0])
        r[0] += calls
        r[1] += calls * int(nbytes)


def merge_records(*parts) -> dict:
    """Sum ``{kind: {group: [calls, bytes]}}`` records."""
    out: dict = {}
    for recs in parts:
        for kind, groups in recs.items():
            for g, (c, b) in groups.items():
                r = out.setdefault(kind, {}).setdefault(int(g), [0, 0])
                r[0] += c
                r[1] += b
    return out


def transpose(recs: dict) -> dict:
    """The backward's calls of forward ``recs`` of all-gathers and
    reduce-scatters that carry a gradient: each all-gather's transpose
    is a reduce-scatter whose result is the gather's input (its bytes
    over the group), each reduce-scatter's an all-gather of its result
    times the group."""
    swap = {"all-gather": ("reduce-scatter", lambda b, k: b // k),
            "reduce-scatter": ("all-gather", lambda b, k: b * k)}
    out: dict = {}
    for kind, groups in recs.items():
        to, size = swap[kind]
        for g, (c, b) in groups.items():
            out.setdefault(to, {})[g] = [c, size(b, g)]
    return out


def train_layer(recs: dict, remat: bool = True) -> dict:
    """A train step's calls of one layer whose forward sends ``recs``:
    the forward, again in its recompute (``remat``), and the
    transposes."""
    return merge_records(recs, recs if remat else {}, transpose(recs))


def _times(recs: dict, n: int) -> dict:
    return merge_records(*[recs] * n) if n > 1 else recs


def collective_schedule(cfg, kind: str, rows: int, seq: int,
                        mesh_shape: dict, rules: dict, specs: dict,
                        shapes: dict, seq_axes=("model",),
                        n_micro: int = 1) -> dict:
    """What ``prefill`` (``kind="prefill"``: ``rows`` x ``seq`` tokens
    on a rank), one ``decode`` step (``rows`` tokens) or one train step
    (``kind="train"``: ``n_micro`` microbatches of ``rows`` x ``seq``
    tokens a rank, ``launch.steps``' cell) sends on one rank, as
    ``Wire`` records it: ``{"global": recs, "layers": [recs a layer],
    "final": recs}``, each ``{kind: {group: [calls, result bytes]}}``.
    ``specs``/``shapes``: every parameter's sanitized spec and global
    shape. A train step counts, a microbatch, ``loss_fn``'s forward,
    each layer's again in its recompute (unless ``cfg.remat`` is
    ``none``), every gather's and reduce-scatter's transpose, and each
    cross-entropy chunk's max all-reduce and sums' ``psum`` (again in
    its recompute, the ``psum`` once more in the backward); then, once
    a step, the losses' ``psum`` and ``_mesh_update``'s gradient and
    norm ``psum``s (the gradients float32 when ``n_micro`` > 1). An MoE
    layer adds, to its FSDP gathers (router, experts, shared expert) and
    attention, the shared expert's gate/up pairing, the combine's reduce
    over ``model`` (where the dense FFN's is), the gather of the expert
    counts over the batch axes where the call can drop slots, and in
    training the aux's top-1 counts in that gather and its probability
    sums' ``psum`` (forward, recompute, backward); the counts carry no
    gradient, so no transpose."""
    el = torch.tensor([], dtype=cfg.dtype).element_size()
    m = mesh_shape.get("model", 1)
    data = [a for a in rules["embed"] if mesh_shape.get(a, 1) > 1]
    d, hd = cfg.d_model, cfg.d_head
    train = kind == "train"
    sp = kind != "decode"

    def m_sharded(name, dim):
        return m > 1 and "model" in part_axes(specs[name][dim])

    def fsdp(recs, names):
        n = sum(block_numel(shapes[k], specs[k], mesh_shape) for k in names
                if any(set(part_axes(p)) & set(data) for p in specs[k]))
        if not n:
            return
        for a in reversed(data):  # minor axis first, as gather_rows
            n *= mesh_shape[a]
            _add(recs, "all-gather", mesh_shape[a], n * el)

    glob: dict = {}
    fsdp(glob, [k for k in ("embed.table", "ln_final.scale", "unembed.table")
                if k in specs])
    tokens = rows * (seq if sp else 1)
    if m_sharded("embed.table", 0):
        if sp:
            _add(glob, "reduce-scatter", m, tokens // m * d * el)
        else:
            _add(glob, "all-gather", m, m * tokens * d * el)
    batch = [a for a in rules["batch"] if mesh_shape.get(a, 1) > 1]
    n_b = int(math.prod(mesh_shape[a] for a in batch))
    remat = train and cfg.remat != "none"
    layers, extras = [], []
    for i in range(cfg.n_layers):
        s = cfg.attn_settings(cfg.layer_kind(i % cfg.group_size))
        pre = f"blocks.{i}."
        recs: dict = {}
        extra: dict = {}  # no gradient: not transposed
        moe = cfg.layer_is_moe(i)
        fsdp(recs, [k for k in specs if k.startswith(pre)])
        if sp:
            _add(recs, "all-gather", m, tokens * d * el, calls=2)  # norms
            for w in ("wk", "wv"):
                if m_sharded(pre + f"attn.{w}.kernel", 1):
                    _add(recs, "all-gather", m,
                         tokens * s.n_kv_heads * hd * el)
            if m > 1:
                _add(recs, "reduce-scatter", m, tokens // m * d * el,
                     calls=2)
        else:
            for w, heads in (("wq", s.n_heads), ("wk", s.n_kv_heads),
                             ("wv", s.n_kv_heads)):
                if m_sharded(pre + f"attn.{w}.kernel", 1):
                    _add(recs, "all-gather", m, tokens * heads * hd * el)
            for a in seq_axes:
                k = mesh_shape.get(a, 1)
                _add(recs, "all-reduce", k, tokens * s.n_heads * 4)
                _add(recs, "all-gather", k, k * tokens * s.n_heads * 4)
                _add(recs, "all-gather", k, k * tokens * s.n_heads * hd * 4)
            _add(recs, "all-gather", m, m * tokens * d * el, calls=2)
        f = (cfg.d_ff if not moe
             else cfg.moe.d_ff * cfg.moe.n_shared)
        if m > 1 and f:  # wi's gate/up pairing
            _add(recs, "all-gather", m,
                 (tokens if tokens < d else d) * 2 * f * el)
        if moe:
            mo = cfg.moe
            drops = tokens * n_b * mo.top_k > mo.dropless_threshold
            n = (int(drops) + int(train)) * mo.n_experts  # int64 counts
            for a in reversed(batch) if n else ():  # minor axis first
                n *= mesh_shape[a]
                _add(extra, "all-gather", mesh_shape[a], n * 8,
                     calls=1 + remat)
            if train:  # the probability sums: forward, recompute, backward
                for a in batch:
                    _add(extra, "all-gather", mesh_shape[a],
                         mesh_shape[a] * mo.n_experts * 4, calls=2 + remat)
        layers.append(recs)
        extras.append(extra)
    final: dict = {}
    if kind == "prefill":
        _add(final, "all-gather", m, m * rows * d * el)
    if not train:
        return {"global": glob, "final": final, "layers": [
            merge_records(r, x) for r, x in zip(layers, extras)]}
    _add(final, "all-gather", m, tokens * d * el)  # the final norm's
    glob = merge_records(glob, transpose(glob))
    layers = [_times(merge_records(train_layer(r, remat), x), n_micro)
              for r, x in zip(layers, extras)]
    final = merge_records(final, transpose(final))
    table = "embed.table" if cfg.tie_embeddings else "unembed.table"
    if m_sharded(table, 0):  # a chunk, its recompute, its backward
        c = min(cfg.ce_chunk, seq)
        _add(final, "all-reduce", m, rows * c * 4, calls=2 * (seq // c))
        _add(final, "all-gather", m, m * 2 * rows * c * 4,
             calls=3 * (seq // c))
    glob, final = _times(glob, n_micro), _times(final, n_micro)
    live = [a for a in mesh_shape if mesh_shape[a] > 1]
    for a in live:  # the losses
        _add(final, "all-gather", mesh_shape[a], mesh_shape[a] * n_micro * 4)
    g_el = 4 if n_micro > 1 else el
    groups: dict = {}
    norms: set = set()
    for name, spec in specs.items():
        have = {a for p in spec for a in part_axes(p)}
        key = tuple(a for a in live if a not in have)
        groups[key] = groups.get(key, 0) + block_numel(
            shapes[name], spec, mesh_shape)
        norms.add(tuple(a for a in live if a in have))
    for key, n in groups.items():  # steps._reduce_grads
        for a in key:
            _add(final, "all-gather", mesh_shape[a], mesh_shape[a] * n * g_el)
    for key in norms - {()}:  # steps._sharded_norm
        for a in key:
            _add(final, "all-gather", mesh_shape[a], mesh_shape[a] * 4)
    return {"global": glob, "layers": layers, "final": final}
