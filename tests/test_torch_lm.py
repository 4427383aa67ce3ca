"""The port's LM serving path against the JAX package, on the CPU.

Seeded numpy inputs and weights go through ``repro``'s function and the
port's counterpart (``repro_torch.nn``, ``repro_torch.models.transformer``):

- per module, at smoke widths: ``rmsnorm`` (both variants), ``layernorm``,
  ``dense``, ``embed``/``unembed``, ``softcap``, ``apply_rope``,
  ``ffn``, ``moe`` (dropless, capacity-dropping and tied router scores,
  aux included), ``attention_scan`` for every kind with softcap, QK-norm
  and GQA, ``prefill_kv`` (the ring layout included) and ``decode_step``;
  the kernel route forced on a CPU tensor (``mha``'s plain version)
  against JAX's ``attention_scan``;
- the whole model, for all five smoke configs with JAX's weights carried
  across by ``params_from_jax``: ``forward`` logits and aux, ``loss_fn``'s
  value, ``prefill``'s last logits and every cache leaf, 8 ``decode``
  steps after an 8-token prefill (JAX's decode-vs-forward protocol),
  decode from ``init_model_cache``'s empty bfloat16 caches, and gemma2's
  ring buffer decoded past its window;
- the full-width configs built on the ``meta`` device: JAX's parameter
  shapes (``jax.eval_shape``) and counts, for all five archs.

Tolerance: 1e-5 relative and 1e-5 absolute in float32, the absolute part
taken relative to the tensor's largest magnitude where that is above 1.
The packages add in other orders (XLA's and PyTorch's matmuls, ``cos``,
``pow`` and ``rsqrt`` may differ in the last bit), and the error of a sum
follows the size of its terms, not of its result: a smoke model's
residual stream and logits reach magnitudes of 30-80, where one float32
unit is 2-8e-6, so a logit near 0 can sit 3e-5 from JAX's. Integer
leaves (``slot_pos``) are bitwise. The one bfloat16 case states its own
tolerance.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import transformer as jtfm
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn import moe as jmoe
from repro.nn import rope as jrope
from repro.nn.module import split_boxed

from repro_torch.configs import base as tbase
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
)
from repro_torch.models import transformer as ttfm
from repro_torch.nn import attention as tattn
from repro_torch.nn import layers as tlayers
from repro_torch.nn import moe as tmoe
from repro_torch.nn import rope as trope
from repro_torch.nn.module import count_params

ARCHS = ["deepseek-coder-33b", "gemma2-2b", "llama4-maverick-400b-a17b",
         "minicpm-2b", "olmoe-1b-7b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def close(got, exp, err_msg="", **tol):
    """A port tensor against a JAX array (or numpy), float32 compare. The
    default is ``TOL``, its absolute part scaled to the tensor's largest
    magnitude where that is above 1."""
    exp = np.asarray(exp, np.float32)
    if not tol:
        scale = max(1.0, float(np.abs(exp).max())) if exp.size else 1.0
        tol = dict(rtol=TOL["rtol"], atol=TOL["atol"] * scale)
    np.testing.assert_allclose(got.detach().float().numpy(), exp,
                               err_msg=err_msg, **tol)


def ns(**tensors):
    """A parameter holder with the port's attribute names."""
    return types.SimpleNamespace(**{k: torch.from_numpy(np.array(v))
                                    for k, v in tensors.items()})


def normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ------------------------------------------------------------ per module --

@pytest.mark.parametrize("zero_centered", [False, True])
def test_rmsnorm_matches_jax(zero_centered):
    rng = np.random.default_rng(0)
    x, scale = normal(rng, (2, 5, 64)), normal(rng, (64,), 0.3)
    exp = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                          1e-6, zero_centered)
    got = tlayers.rmsnorm(ns(scale=scale), torch.from_numpy(x), 1e-6,
                          zero_centered)
    close(got, exp)


def test_layernorm_dense_embed_unembed_match_jax():
    rng = np.random.default_rng(7)
    x = normal(rng, (2, 5, 64))
    scale, bias = normal(rng, (64,), 0.3), normal(rng, (64,), 0.3)
    exp = jlayers.layernorm({"scale": jnp.asarray(scale),
                             "bias": jnp.asarray(bias)}, jnp.asarray(x))
    close(tlayers.layernorm(ns(scale=scale, bias=bias), torch.from_numpy(x)),
          exp)
    kernel, table = normal(rng, (64, 32)), normal(rng, (40, 64))
    close(tlayers.dense(ns(kernel=kernel), torch.from_numpy(x)),
          jlayers.dense({"kernel": jnp.asarray(kernel)}, jnp.asarray(x)))
    ids = rng.integers(0, 40, (2, 5)).astype(np.int32)
    close(tlayers.embed(ns(table=table), torch.from_numpy(ids)),
          jlayers.embed({"table": jnp.asarray(table)}, jnp.asarray(ids)))
    close(tlayers.unembed(ns(table=table), torch.from_numpy(x)),
          jlayers.unembed({"table": jnp.asarray(table)}, jnp.asarray(x)))
    close(tlayers.softcap(torch.from_numpy(x * 40), 30.0),
          jlayers.softcap(jnp.asarray(x * 40), 30.0))


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = normal(rng, (2, 16, 4, 16))
    pos = np.stack([np.arange(16), np.arange(100, 116)]).astype(np.int32)
    exp = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    close(got, exp)


def swiglu_weights(rng, d, d_ff, lead=()):
    return {"wi": {"kernel": normal(rng, (*lead, d, 2 * d_ff), d ** -0.5)},
            "wo": {"kernel": normal(rng, (*lead, d_ff, d), d_ff ** -0.5)}}


def torch_swiglu(w):
    return types.SimpleNamespace(
        wi=ns(kernel=w["wi"]["kernel"]), wo=ns(kernel=w["wo"]["kernel"]))


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_ffn_matches_jax():
    rng = np.random.default_rng(2)
    w = swiglu_weights(rng, 64, 128)
    x = normal(rng, (2, 8, 64))
    exp = jmoe.ffn(jnp_tree(w), jnp.asarray(x))
    close(tmoe.ffn(torch_swiglu(w), torch.from_numpy(x)), exp)


MOE_CASES = {
    # T*K = 64 slots under the threshold: C = T*K, nothing drops
    "dropless": (jmoe.MoESettings(n_experts=8, top_k=2, d_ff=32), False),
    # threshold 0 and C = int(0.5 * 64 / 8) = 4: most experts overflow
    "dropping": (jmoe.MoESettings(n_experts=8, top_k=2, d_ff=32,
                                  capacity_factor=0.5,
                                  dropless_threshold=0), False),
    # a zero router: every score ties, top-k takes the lowest indices
    "ties": (jmoe.MoESettings(n_experts=8, top_k=2, d_ff=32, n_shared=1),
             True),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_matches_jax(case):
    m, zero_router = MOE_CASES[case]
    rng = np.random.default_rng(3)
    d = 64
    w = {"router": {"kernel": normal(rng, (d, m.n_experts),
                                     0.0 if zero_router else 1.0)},
         "experts": swiglu_weights(rng, d, m.d_ff, (m.n_experts,))}
    if m.n_shared:
        w["shared"] = swiglu_weights(rng, d, m.d_ff * m.n_shared)
    x = normal(rng, (2, 16, d))
    exp, exp_aux = jmoe.moe(jnp_tree(w), m, jnp.asarray(x))
    tw = types.SimpleNamespace(router=ns(kernel=w["router"]["kernel"]),
                               experts=torch_swiglu(w["experts"]))
    if m.n_shared:
        tw.shared = torch_swiglu(w["shared"])
    tm = tmoe.MoESettings(**dataclasses.asdict(m))
    got, aux = tmoe.moe(tw, tm, torch.from_numpy(x))
    close(got, exp)
    close(aux, exp_aux)
    if case == "dropping":  # the case must drop slots to test dropping
        logits = x.reshape(32, d) @ w["router"]["kernel"]
        top = np.argsort(-logits, axis=1, kind="stable")[:, :2].reshape(-1)
        assert np.bincount(top, minlength=8).max() > 4


ATTN_CASES = {
    "global_gqa": dict(n_heads=4, n_kv_heads=2),
    "global_mha_qknorm": dict(n_heads=4, n_kv_heads=4, qk_norm=True),
    "global_nope": dict(n_heads=8, n_kv_heads=2, kind="global_nope"),
    "local_softcap": dict(n_heads=4, n_kv_heads=2, kind="local", window=32,
                          logit_softcap=50.0),
    "chunk_gqa": dict(n_heads=8, n_kv_heads=2, kind="chunk", window=32),
    "global_query_scale": dict(n_heads=4, n_kv_heads=2, query_scale=0.2),
}


def attn_settings(case, d_head=16):
    kw = dict(d_model=64, d_head=d_head, chunk_q=64, **ATTN_CASES[case])
    return jattn.AttnSettings(**kw), tattn.AttnSettings(**kw)


def attn_weights(s, seed=4):
    rng = np.random.default_rng(seed)
    d, h, kv, hd = s.d_model, s.n_heads, s.n_kv_heads, s.d_head
    w = {"wq": {"kernel": normal(rng, (d, h * hd), d ** -0.5)},
         "wk": {"kernel": normal(rng, (d, kv * hd), d ** -0.5)},
         "wv": {"kernel": normal(rng, (d, kv * hd), d ** -0.5)},
         "wo": {"kernel": normal(rng, (h * hd, d), (h * hd) ** -0.5)}}
    if s.qk_norm:
        w["q_norm"] = {"scale": 1.0 + normal(rng, (hd,), 0.2)}
        w["k_norm"] = {"scale": 1.0 + normal(rng, (hd,), 0.2)}
    tw = types.SimpleNamespace(**{
        k: ns(**{kk: vv for kk, vv in v.items()}) for k, v in w.items()})
    return jnp_tree(w), tw


def seq_inputs(b, seq, d=64, seed=5):
    rng = np.random.default_rng(seed)
    x = normal(rng, (b, seq, d))
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (b, seq)).copy()
    return x, pos


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_scan_matches_jax(case):
    js, ts = attn_settings(case)
    jw, tw = attn_weights(js)
    x, pos = seq_inputs(2, 128)
    exp = jattn.attention_scan(jw, js, jnp.asarray(x), jnp.asarray(pos))
    before = dict(tattn.route_calls)
    got = tattn.attention_scan(tw, ts, torch.from_numpy(x),
                               torch.from_numpy(pos))
    close(got, exp)
    assert tattn.route_calls["scan"] == before["scan"] + 1
    # on a CPU tensor the chosen route is the scan too
    assert tattn.choose_route(ts, torch.from_numpy(x)) == "scan"


@pytest.mark.parametrize("case", ["global_gqa", "global_mha_qknorm",
                                  "global_nope", "global_query_scale"])
@pytest.mark.parametrize("seq", [128, 256])
def test_forced_kernel_route_matches_jax_scan(case, seq):
    """The kernel route's wiring (q, k, v to [B, H, S, D], GQA by
    ``repeat_interleave``, the query-scale fold, ``wo``) through ``mha``'s
    plain version on the CPU, against JAX's ``attention_scan``."""
    js, ts = attn_settings(case)
    jw, tw = attn_weights(js)
    x, pos = seq_inputs(2, seq)
    exp = jattn.attention_scan(jw, js, jnp.asarray(x), jnp.asarray(pos))
    before, launches = dict(tattn.route_calls), flash_attention.launches
    got = tattn.attention(tw, ts, torch.from_numpy(x), torch.from_numpy(pos),
                          route="kernel")
    close(got, exp)
    assert tattn.route_calls["kernel"] == before["kernel"] + 1
    assert tattn.route_calls["scan"] == before["scan"]
    assert flash_attention.launches == launches  # the plain version ran


def test_gqa_expansion_maps_query_head_to_kv_head():
    """Query head h reads kv head h // G: with one kv head's values set
    apart, exactly its G query heads see them."""
    b, seq, kv, g, hd = 1, 128, 2, 3, 8
    s = tattn.AttnSettings(d_model=8, n_heads=kv * g, n_kv_heads=kv,
                           d_head=hd)
    q = torch.zeros((b, seq, kv * g, hd))
    k = torch.zeros((b, seq, kv, hd))
    v = torch.zeros((b, seq, kv, hd))
    v[:, :, 1] = 1.0
    out = tattn._attend_kernel(s, q, k, v).reshape(b, seq, kv * g, hd)
    assert torch.equal(out[:, :, :g], torch.zeros_like(out[:, :, :g]))
    # a softmax-weighted mean of up to 128 ones, summed in float32
    assert torch.allclose(out[:, :, g:], torch.ones_like(out[:, :, g:]),
                          rtol=0, atol=1e-5)


def test_route_choice_raises_where_the_kernel_does_not_apply():
    x = torch.zeros((1, 128, 64))
    for case in ("local_softcap", "chunk_gqa"):
        _, ts = attn_settings(case)
        with pytest.raises(ValueError, match="kernel route does not apply"):
            tattn.choose_route(ts, x, "kernel")
    _, ts = attn_settings("global_gqa")
    with pytest.raises(ValueError, match="kernel route does not apply"):
        tattn.choose_route(ts, torch.zeros((1, 100, 64)), "kernel")
    with pytest.raises(ValueError, match="kernel route does not apply"):
        tattn.choose_route(ts, x.half(), "kernel")
    with pytest.raises(ValueError, match="unknown attention route"):
        tattn.choose_route(ts, x, "sdpa")
    assert tattn.choose_route(ts, x, "kernel") == "kernel"
    assert tattn.choose_route(ts, x) == "scan"  # a CPU tensor


def cache_close(got, exp, what):
    close(got.k, exp.k, f"{what} k")
    close(got.v, exp.v, f"{what} v")
    np.testing.assert_array_equal(got.slot_pos.numpy(),
                                  np.asarray(exp.slot_pos), f"{what} pos")
    assert got.slot_pos.dtype == torch.int32


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("seq,max_seq", [(40, 48), (64, 64)])
def test_prefill_kv_and_decode_step_match_jax(case, seq, max_seq):
    """A prefill's cache (window 32 < 40: the ring layout), then decode
    steps to ``max_seq`` (past the window for local and chunk kinds)."""
    js, ts = attn_settings(case)
    jw, tw = attn_weights(js)
    x, pos = seq_inputs(2, seq)
    jc = jattn.prefill_kv(jw, js, jnp.asarray(x), jnp.asarray(pos), max_seq)
    tc = tattn.prefill_kv(tw, ts, torch.from_numpy(x), torch.from_numpy(pos),
                          max_seq)
    cache_close(tc, jc, "prefill")
    rng = np.random.default_rng(6)
    for p in range(seq, max_seq + 8):
        xs = normal(rng, (2, 1, 64))
        exp, jc = jattn.decode_step(jw, js, jnp.asarray(xs), jc,
                                    jnp.int32(p))
        got, tc = tattn.decode_step(tw, ts, torch.from_numpy(xs), tc, p)
        close(got, exp, f"decode pos {p}")
        cache_close(tc, jc, f"decode pos {p}")


# ------------------------------------------------------------ the model --

def jax_cfg(arch, full=False):
    spec = jbase.get(arch)
    return spec.full_config() if full else spec.smoke_config()


def port_cfg(arch, full=False):
    spec = tbase.get(arch)
    return spec.full_config() if full else spec.smoke_config()


def jax_params(cfg, seed=0):
    params, _ = split_boxed(jtfm.init(jax.random.PRNGKey(seed), cfg))
    return params


def carried(arch, seed=0, **replace):
    """JAX's smoke model and the port's holding the same weights."""
    jc = dataclasses.replace(jax_cfg(arch), **replace)
    tc = dataclasses.replace(port_cfg(arch), **{
        k: (torch.bfloat16 if v == jnp.bfloat16 else v)
        for k, v in replace.items()})
    jp = jax_params(jc, seed)
    tree = jax.tree.map(np.asarray, jp)
    return jc, jp, tc, ttfm.params_from_jax(tc, tree, device="cpu")


def tokens(cfg, b, seq, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, seq)).astype(np.int32)


def model_caches_close(cfg, got, exp, what):
    """The port's per-layer caches against JAX's per-slot stacked ones."""
    assert len(got) == cfg.n_layers
    for i, c in enumerate(got):
        g, j = divmod(i, cfg.group_size)
        jc = jax.tree.map(lambda a: a[g], exp[f"layer_{j}"])
        cache_close(c, jc, f"{what} layer {i}")


def test_configs_and_registry_match_jax():
    cells, skips = tbase.all_cells()
    jcells, jskips = jbase.all_cells()
    assert sorted(c for c in cells if c[0] in ARCHS) == sorted(
        c for c in jcells if c[0] in ARCHS)
    assert sorted(s for s in skips if s[0] in ARCHS) == sorted(
        s for s in jskips if s[0] in ARCHS)
    # the LM family (the GNN family's registry is held in test_torch_gnn)
    assert sorted(a for a, spec in tbase.all_archs().items()
                  if spec.family == "lm") == ARCHS
    for arch in ARCHS:
        for full in (False, True):
            j, t = jax_cfg(arch, full), port_cfg(arch, full)
            jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
            assert {jnp.float32: torch.float32, jnp.bfloat16:
                    torch.bfloat16}[jd.pop("dtype")] == td.pop("dtype")
            assert jd == td, arch
            assert (j.vocab_padded, j.group_size, j.n_groups,
                    j.active_params(), j.total_params()) == (
                t.vocab_padded, t.group_size, t.n_groups,
                t.active_params(), t.total_params())
            assert [j.layer_kind(i) for i in range(j.n_layers)] == [
                t.layer_kind(i) for i in range(t.n_layers)]
            assert [j.layer_is_moe(i) for i in range(j.n_layers)] == [
                t.layer_is_moe(i) for i in range(t.n_layers)]
            assert dataclasses.asdict(j.attn_settings("local")) == (
                dataclasses.asdict(t.attn_settings("local")))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    jc, jp, tc, model = carried(arch)
    toks = tokens(jc, 2, 16)
    exp, exp_aux = jtfm.forward(jp, jc, jnp.asarray(toks))
    got, aux = ttfm.forward(model, tc, torch.from_numpy(toks))
    assert got.shape == (2, 16, tc.vocab_padded) and got.dtype == torch.float32
    close(got, exp)
    close(aux, exp_aux)
    assert bool((got[..., tc.vocab:] < -1e29).all())
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    exp_loss = jtfm.loss_fn(jp, jc, jax.tree.map(jnp.asarray, batch))
    loss = ttfm.loss_fn(model, tc, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    close(loss, exp_loss)
    # the module call is forward
    close(model(torch.from_numpy(toks))[0], exp)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill 8 tokens, then decode 8..15 one at a time: the port against
    JAX's prefill and decode (1e-5; last logits and every cache leaf after
    each step), and against JAX's forward at the tolerance of JAX's own
    decode-vs-forward test (``tests/test_lm_smoke.py``)."""
    jc, jp, tc, model = carried(arch)
    toks = tokens(jc, 2, 16)
    full, _ = jtfm.forward(jp, jc, jnp.asarray(toks))
    exp, jcache = jtfm.prefill(jp, jc, jnp.asarray(toks[:, :8]), max_seq=16)
    got, tcache = ttfm.prefill(model, tc, torch.from_numpy(toks[:, :8]),
                               max_seq=16)
    assert got.shape == (2, tc.vocab_padded)
    close(got, exp)
    model_caches_close(tc, tcache, jcache, "prefill")
    v = tc.vocab
    close(got[:, :v], full[:, 7, :v], rtol=2e-4, atol=2e-4)
    for p in range(8, 16):
        exp, jcache = jtfm.decode(jp, jc, jcache,
                                  jnp.asarray(toks[:, p:p + 1]), jnp.int32(p))
        got, tcache = ttfm.decode(model, tc, tcache,
                                  torch.from_numpy(toks[:, p:p + 1]), p)
        close(got, exp, f"{arch} decode pos {p}")
        model_caches_close(tc, tcache, jcache, f"decode pos {p}")
        close(got[:, 0, :v], full[:, p, :v], f"{arch} vs forward pos {p}",
              rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("arch", ["gemma2-2b", "minicpm-2b"])
def test_decode_from_empty_cache_matches_jax(arch):
    """``init_model_cache``: bfloat16 by default as in JAX, every empty
    leaf equal; then 6 decode steps from position 0 on float32 caches
    (a bfloat16 cache under a float32 model rounds k and v, and a value
    within 1e-5 of JAX's can round to the neighbouring bfloat16 value)."""
    jc, jp, tc, model = carried(arch)
    model_caches_close(tc, ttfm.init_model_cache(tc, 2, 40, device="cpu"),
                       jtfm.init_model_cache(jc, 2, 40), "empty")
    default = ttfm.init_model_cache(tc, 2, 40, device="cpu")
    assert {c.k.dtype for c in default} == {torch.bfloat16}
    jcache = jtfm.init_model_cache(jc, 2, 40, jnp.float32)
    tcache = ttfm.init_model_cache(tc, 2, 40, torch.float32, "cpu")
    toks = tokens(jc, 2, 6, seed=3)
    for p in range(6):
        exp, jcache = jtfm.decode(jp, jc, jcache,
                                  jnp.asarray(toks[:, p:p + 1]), jnp.int32(p))
        got, tcache = ttfm.decode(model, tc, tcache,
                                  torch.from_numpy(toks[:, p:p + 1]), p)
        close(got, exp, f"{arch} decode pos {p}")
        model_caches_close(tc, tcache, jcache, f"decode pos {p}")


def test_ring_buffer_window_decode_matches_jax():
    """gemma2's local layers decoded past their window (32): prefill 40 of
    48 tokens, decode 40..47 (``test_ring_buffer_window_decode``)."""
    jc, jp, tc, model = carried("gemma2-2b")
    assert tc.window == 32
    toks = tokens(jc, 1, 48, seed=2)
    full, _ = jtfm.forward(jp, jc, jnp.asarray(toks))
    _, jcache = jtfm.prefill(jp, jc, jnp.asarray(toks[:, :40]), max_seq=48)
    _, tcache = ttfm.prefill(model, tc, torch.from_numpy(toks[:, :40]),
                             max_seq=48)
    assert tcache[0].k.shape[1] == 32 and tcache[1].k.shape[1] == 48
    model_caches_close(tc, tcache, jcache, "prefill")
    v = tc.vocab
    for p in range(40, 48):
        exp, jcache = jtfm.decode(jp, jc, jcache,
                                  jnp.asarray(toks[:, p:p + 1]), jnp.int32(p))
        got, tcache = ttfm.decode(model, tc, tcache,
                                  torch.from_numpy(toks[:, p:p + 1]), p)
        close(got, exp, f"window decode pos {p}")
        model_caches_close(tc, tcache, jcache, f"window decode pos {p}")
        close(got[:, 0, :v], full[:, p, :v], rtol=5e-4, atol=5e-4)


def test_minicpm_smoke_bfloat16_matches_jax():
    """MiniCPM-smoke in bfloat16, weights carried across by their bits.
    Both packages round every intermediate to bfloat16, but not always
    the same way: a matmul's float32 sum, added in another order, can
    round to the neighbouring bfloat16 value, and the difference carries
    through the layers. Tolerance: 2^-5 of the logits' largest magnitude
    (about four bfloat16 units at that scale), absolute."""
    jc, jp, tc, model = carried("minicpm-2b", dtype=jnp.bfloat16)
    assert model.embed.table.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.embed.table.float().numpy(),
        np.asarray(jp["embed"]["table"], np.float32))
    toks = tokens(jc, 2, 16)
    exp, _ = jtfm.forward(jp, jc, jnp.asarray(toks))
    got, _ = ttfm.forward(model, tc, torch.from_numpy(toks))
    v = tc.vocab
    exp = np.asarray(exp, np.float32)[..., :v]
    tol = 2 ** -5 * float(np.abs(exp).max())
    close(got[..., :v], exp, rtol=0, atol=tol)
    exp_last, _ = jtfm.prefill(jp, jc, jnp.asarray(toks[:, :8]), max_seq=16)
    got_last, tcache = ttfm.prefill(model, tc, torch.from_numpy(toks[:, :8]),
                                    max_seq=16)
    assert tcache[0].k.dtype == torch.bfloat16
    close(got_last[:, :v], np.asarray(exp_last, np.float32)[:, :v], rtol=0,
          atol=tol)


def test_params_round_trip_and_copy():
    cfg = jax_cfg("llama4-maverick-400b-a17b")
    tree = jax.tree.map(lambda a: np.array(a), jax_params(cfg))
    tc = port_cfg("llama4-maverick-400b-a17b")
    model = ttfm.params_from_jax(tc, tree, device="cpu")
    back = ttfm.params_to_numpy(model)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len({ttfm.jax_path(tc, name)[0]
                             for name, _ in model.named_parameters()})
    for path, leaf in flat:
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, leaf, str(path))
    # the model holds copies: writing a (writable) source leaf changes
    # nothing in it
    before = model.embed.table.clone()
    tree["embed"]["table"][:] = 0.0
    assert torch.equal(model.embed.table, before)
    # a tree of another shape is refused
    tree["ln_final"]["scale"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="ln_final.scale"):
        ttfm.params_from_jax(tc, tree, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_structure_matches_jax(arch):
    """The published configs on the ``meta`` device: every parameter has
    JAX's shape (its group slice for block leaves) and the counts agree."""
    jc, tc = jax_cfg(arch, full=True), port_cfg(arch, full=True)
    abstract = jax.eval_shape(lambda: jtfm.init(jax.random.PRNGKey(0), jc))
    shapes, _ = split_boxed(abstract)
    model = ttfm.init(tc, None, device="meta")
    assert model.embed.table.device.type == "meta"
    n_jax = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        n_jax += int(np.prod(leaf.shape))
    assert count_params(model) == n_jax
    for name, p in model.named_parameters():
        path, g = ttfm.jax_path(tc, name)
        leaf = shapes
        for key in path:
            leaf = leaf[key]
        want = leaf.shape if g is None else leaf.shape[1:]
        assert tuple(p.shape) == tuple(want), name
        assert p.dtype == tc.dtype
    if arch == "minicpm-2b":
        assert count_params(model) == 2_725_173_504
