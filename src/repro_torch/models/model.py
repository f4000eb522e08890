"""Model assembly for the ported slices, counterpart of ``repro/models/model.py``.

The reference stacks layer groups on a leading axis and scans over them;
here ``params["groups"]`` is a Python list of per-group dicts and the layer
loop is a Python loop.  A group's slots are attention, Mamba, mLSTM or
sLSTM blocks (``slot_spec``; xLSTM's alternate by ``cfg.xlstm.pattern``
and have no FFN) under RMSNorm or LayerNorm (``cfg.norm``), the attention
and Mamba blocks each with a dense FFN or a mixture-of-experts one
(``layers.moe_apply``), SwiGLU or GELU (``cfg.mlp_type``), whose
load-balance and z-losses the forward sums over layers into ``aux``.  An
encoder-decoder (``cfg.enc_dec``, Whisper) adds ``params["encoder"]``, a
list of ``enc_layers`` per-layer dicts as
``groups`` is (``encode_audio``: non-causal self-attention over the
frames of a stubbed frontend plus sinusoidal positions), ``enc_norm``, the
learned decoder positions ``dec_pos`` in place of rope, and in every
decoder slot a cross-attention block (``norm_x``, ``cross``) over the
encoder's output, whose K/V the prefill leaves in the cache as
``cross_k`` / ``cross_v`` for decode to read.  Caches keep the
reference's stacked layout, one ``(G, B, ...)`` tensor per leaf, and
decode writes into it in place (``cache[...]["k"][g]`` is a view of the
stacked tensor).

The training forward (``embed_inputs``, ``forward``, ``forward_groups`` with
``remat``) recomputes each group in the backward, as the reference's
``jax.checkpoint`` of the group body does: ``remat`` is
``torch.utils.checkpoint`` (non-reentrant) around each group, applied only
where autograd will need the group's activations; the group's aux terms
pass through it with its output.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.models import layers as L
from repro_torch.tree import tree_leaves


# --------------------------------------------------------------------------
# group structure
# --------------------------------------------------------------------------

def group_size(cfg: ModelConfig) -> int:
    """Smallest g dividing n_layers such that (kind, is_moe) repeats mod g."""
    pattern = [(cfg.block_kind(l), cfg.layer_is_moe(l))
               for l in range(cfg.n_layers)]
    for g in range(1, cfg.n_layers + 1):
        if cfg.n_layers % g:
            continue
        if all(pattern[l] == pattern[l % g] for l in range(cfg.n_layers)):
            return g
    return cfg.n_layers


def slot_spec(cfg: ModelConfig):
    """[(kind, is_moe, has_ffn)] for each slot inside a group."""
    out = []
    for l in range(group_size(cfg)):
        kind = cfg.block_kind(l)
        has_ffn = kind in ("attn", "mamba") and cfg.d_ff > 0
        out.append((kind, cfg.layer_is_moe(l) and has_ffn, has_ffn))
    return out


def n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // group_size(cfg)


# --------------------------------------------------------------------------
# init (same shapes and scales as the reference; torch's generator gives
# other numbers than threefry, so tests share weights via repro_torch.convert)
# --------------------------------------------------------------------------

def _normal(gen, shape, scale, dtype, device):
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (t * scale).to(dtype)


def _dense_init(gen, d_in, d_out, dtype, device, bias=False, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def _norm_init(kind, d, dtype, device):
    """The reference's ``norm_init``: a scale of ones, and for LayerNorm a
    bias of zeros."""
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def _mlp_init(gen, cfg, dtype, device):
    """The reference's ``mlp_init``: SwiGLU (``wg``, ``wu``, ``wd``), or
    the GELU MLP (``w1``, ``w2``, each with a bias of zeros)."""
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {"wg": _dense_init(gen, d, ff, dtype, device),
                "wu": _dense_init(gen, d, ff, dtype, device),
                "wd": _dense_init(gen, ff, d, dtype, device)}
    return {"w1": _dense_init(gen, d, ff, dtype, device, bias=True),
            "w2": _dense_init(gen, ff, d, dtype, device, bias=True)}


def _attention_init(gen, cfg, dtype, device):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bias = cfg.qkv_bias
    return {
        "wq": _dense_init(gen, d, h * hd, dtype, device, bias=bias),
        "wk": _dense_init(gen, d, kv * hd, dtype, device, bias=bias),
        "wv": _dense_init(gen, d, kv * hd, dtype, device, bias=bias),
        "wo": _dense_init(gen, h * hd, d, dtype, device,
                          scale=1.0 / math.sqrt(h * hd
                                                * max(cfg.n_layers, 1))),
    }


def _mamba_init(gen, cfg, dtype, device):
    """The reference's ``mamba_init``: A_log = log(1..N) tiled over d_inner
    and D = 1, both fp32 whatever the storage dtype; conv_b = 0; dt_proj
    scaled by dt_rank**-0.5."""
    d = cfg.d_model
    d_in, dt_rank, n, d_conv = L.mamba_dims(cfg)
    a = torch.arange(1, n + 1, dtype=torch.float32,
                     device=device)[None].repeat(d_in, 1)
    return {
        "in_proj": _dense_init(gen, d, 2 * d_in, dtype, device),
        "conv_w": _normal(gen, (d_conv, d_in), 1.0 / math.sqrt(d_conv),
                          dtype, device),
        "conv_b": torch.zeros((d_in,), dtype=dtype, device=device),
        "x_proj": _dense_init(gen, d_in, dt_rank + 2 * n, dtype, device),
        "dt_proj": _dense_init(gen, dt_rank, d_in, dtype, device, bias=True,
                               scale=dt_rank ** -0.5),
        "A_log": torch.log(a),
        "D": torch.ones((d_in,), dtype=torch.float32, device=device),
        "out_proj": _dense_init(gen, d_in, d, dtype, device),
    }


def _moe_init(gen, cfg, dtype, device):
    """The reference's ``moe_init``: an fp32 (d, E) router and experts
    stacked (E, d, ff) / (E, ff, d), SwiGLU (``wg``, ``wu``, ``wd``) or
    GELU (``w1``, ``w2``, no biases)."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    p = {"router": _normal(gen, (d, e), 1.0 / math.sqrt(d), torch.float32,
                           device)}
    names = (("wg", "wu", "wd") if cfg.mlp_type == "swiglu"
             else ("w1", "w2"))
    for name in names:
        down = name in ("wd", "w2")
        shape, fan_in = ((e, ff, d), ff) if down else ((e, d, ff), d)
        p[name] = _normal(gen, shape, 1.0 / math.sqrt(fan_in), dtype, device)
    return p


def _mlstm_init(gen, cfg, dtype, device):
    """The reference's ``mlstm_init``: the up projection to 2 d_up (x and
    the z gate), q/k/v over d_up, the per-head gates ``w_i``/``w_f`` (with
    biases) fp32 whatever the storage dtype, and ``down``."""
    d = cfg.d_model
    d_up = int(cfg.xlstm.proj_factor * d)
    p = {"up": _dense_init(gen, d, 2 * d_up, dtype, device)}
    for name in ("wq", "wk", "wv"):
        p[name] = _dense_init(gen, d_up, d_up, dtype, device)
    for name in ("w_i", "w_f"):
        p[name] = _dense_init(gen, d, cfg.n_heads, torch.float32, device,
                              bias=True)
    p["down"] = _dense_init(gen, d_up, d, dtype, device)
    return p


def _slstm_init(gen, cfg, dtype, device):
    """The reference's ``slstm_init``: ``w_in`` to the four gates (with a
    bias), the block-diagonal recurrent ``r`` (one (dh, 4dh) block a head,
    scaled by dh**-0.5) and ``out``."""
    d, hn = cfg.d_model, cfg.n_heads
    dh = d // hn
    return {"w_in": _dense_init(gen, d, 4 * d, dtype, device, bias=True),
            "r": _normal(gen, (hn, dh, 4 * dh), 1.0 / math.sqrt(dh), dtype,
                         device),
            "out": _dense_init(gen, d, d, dtype, device)}


_MIXER_INIT = {"attn": _attention_init, "mamba": _mamba_init,
               "mlstm": _mlstm_init, "slstm": _slstm_init}


def _slot_init(gen, cfg, kind, is_moe, has_ffn, dtype, device,
               cross=False):
    d = cfg.d_model
    p = {"norm1": _norm_init(cfg.norm, d, dtype, device),
         kind: _MIXER_INIT[kind](gen, cfg, dtype, device)}
    if cross:
        p["norm_x"] = _norm_init(cfg.norm, d, dtype, device)
        p["cross"] = _attention_init(gen, cfg, dtype, device)
    if has_ffn:
        p["norm2"] = _norm_init(cfg.norm, d, dtype, device)
        if is_moe:
            p["moe"] = _moe_init(gen, cfg, dtype, device)
        else:
            p["mlp"] = _mlp_init(gen, cfg, dtype, device)
    return p


def _refuse_gather(cfg) -> None:
    if cfg.moe_gather_weights:
        raise NotImplementedError(
            "moe_gather_weights is a sharding constraint over a mesh of "
            "cards, which one card does not have (ROADMAP A, step 5: "
            "DeviceMesh/DTensor)")


def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                device=None) -> Dict[str, Any]:
    """Random params in ``cfg.param_dtype`` on ``device`` (default: the
    generator's); ``device="meta"`` gives the tree's shapes and dtypes
    without memory or values."""
    _refuse_gather(cfg)
    dtype = torch_dtype(cfg.param_dtype)
    device = gen.device if device is None else torch.device(device)
    slots = slot_spec(cfg)
    params: Dict[str, Any] = {
        "tok_embed": _normal(gen, (cfg.vocab_padded, cfg.d_model), 0.02,
                             dtype, device),
        "final_norm": _norm_init(cfg.norm, cfg.d_model, dtype, device),
        "groups": [{f"slot_{i}": _slot_init(gen, cfg, kind, is_moe, has_ffn,
                                            dtype, device, cross=cfg.enc_dec)
                    for i, (kind, is_moe, has_ffn) in enumerate(slots)}
                   for _ in range(n_groups(cfg))],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = _normal(gen, (cfg.d_model, cfg.vocab_padded),
                                    1.0 / math.sqrt(cfg.d_model), dtype,
                                    device)
    if cfg.enc_dec:
        params["encoder"] = [
            {"slot_0": _slot_init(gen, cfg, "attn", False, cfg.d_ff > 0,
                                  dtype, device)}
            for _ in range(cfg.enc_layers)]
        params["enc_norm"] = _norm_init(cfg.norm, cfg.d_model, dtype, device)
        params["dec_pos"] = _normal(gen, (cfg.max_seq, cfg.d_model), 0.02,
                                    dtype, device)
    if cfg.frontend == "vision":
        params["img_proj"] = _dense_init(gen, cfg.d_model, cfg.d_model, dtype,
                                         device)
    return params


# leaves the reference casts to the compute dtype at their op besides the
# matmul weights: the embedding tables (a last stage's frozen tied copy
# among them, which staged serving unembeds with, and Whisper's learned
# decoder positions), the Mamba conv and the
# stacked experts, SwiGLU or GELU (a dense FFN's wg/wu/wd and w1/w2 are
# dicts with a "w", cast as every such dict is).  A_log, D and the MoE
# router stay fp32 (the reference reads them in fp32), as do the norms'
# scales and LayerNorm's biases.  sLSTM's bare ``r`` stays too, and so do
# mLSTM's gate projections ``w_i``/``w_f``, dicts with a "w" that the
# reference reads in fp32 (``dense(p["w_i"], x.astype(jnp.float32))``).
_CAST_LEAVES = ("tok_embed", "unembed", "tied_unembed", "dec_pos", "conv_w",
                "conv_b", "wg", "wu", "wd", "w1", "w2")
_KEEP_LEAVES = ("w_i", "w_f")


def compute_copy(params, dtype: torch.dtype):
    """The params with every matmul weight and bias, the embedding tables,
    the Mamba conv weights and the experts cast once to the compute dtype;
    norm scales and biases, ``A_log``, ``D``, the router, sLSTM's ``r`` and
    mLSTM's gate projections keep their storage dtype.  The layers then
    read them without a per-op cast, with the same values the per-op cast
    gives."""
    def walk(node, in_dense):
        if isinstance(node, dict):
            dense_like = "w" in node
            return {k: v if k in _KEEP_LEAVES
                    else walk(v, dense_like or k in _CAST_LEAVES)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, False) for v in node]
        return L.as_dtype(node, dtype) if in_dense else node
    return walk(params, False)


# --------------------------------------------------------------------------
# embed / forward / unembed
# --------------------------------------------------------------------------

def embed_tokens(cfg, params, tokens, dtype):
    return L.as_dtype(params["tok_embed"], dtype)[tokens]


def sinusoidal(seq, d, device):
    """(seq, d) fp32 positions: the sines of every pair's angle, then their
    cosines (concatenated, not interleaved), as the reference's."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    ang = pos * div[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d]


def encode_audio(cfg, params, frames):
    """The Whisper encoder over precomputed (stub-frontend) frames
    (B, T_enc, d): sinusoidal positions, then each encoder layer's
    non-causal self-attention and GELU MLP, then ``enc_norm``."""
    dtype = cfg.activation_dtype()
    x = L.as_dtype(frames, dtype) + sinusoidal(
        frames.shape[1], cfg.d_model, frames.device).to(dtype)
    for layer in params["encoder"]:
        sp = layer["slot_0"]
        out, _ = L.attention_apply(sp["attn"], L.norm_apply(sp["norm1"], x),
                                   cfg, rope_cs=None, causal=False)
        x = L.residual_add(x, out)
        if "norm2" in sp:
            x = L.residual_add(
                x, L.mlp_apply(sp["mlp"], L.norm_apply(sp["norm2"], x)))
    return L.norm_apply(params["enc_norm"], x)


def embed_inputs(cfg, params, batch):
    """Returns (x (B,S,d), enc_out, n_prefix) for training/prefill: enc_out
    the encoder's output over ``batch["frames"]`` for an encoder-decoder
    (whose tokens add the learned ``dec_pos``), else None.  A vision
    config's stubbed frontend projects ``batch["image_embeds"]`` (B,
    vision_tokens, d) through ``img_proj`` in the compute dtype and
    prepends the rows to the text: n_prefix is their count, else 0."""
    dtype = cfg.activation_dtype()
    tokens = batch["tokens"]
    x = embed_tokens(cfg, params, tokens, dtype)
    if cfg.enc_dec:
        enc_out = encode_audio(cfg, params, batch["frames"])
        x = x + L.as_dtype(params["dec_pos"], dtype)[None, :tokens.shape[1]]
        return x, enc_out, 0
    if cfg.frontend == "vision":
        img = L.dense(params["img_proj"],
                      L.as_dtype(batch["image_embeds"], dtype))
        return torch.cat([img, x], dim=1), None, img.shape[1]
    return x, None, 0


def rope_for(cfg, positions):
    """The rope tables of ``positions``; None for an encoder-decoder, whose
    decoder has learned positions."""
    if cfg.enc_dec:
        return None
    return L.rope_tables(positions, cfg.hd, cfg.rope_fraction, cfg.rope_theta)


def _ffn(cfg, sp, is_moe, h):
    """The slot's FFN on h: (out, aux or None)."""
    if not is_moe:
        return L.mlp_apply(sp["mlp"], h), None
    _refuse_gather(cfg)
    return L.moe_apply(sp["moe"], h, cfg.moe,
                       groups=cfg.moe_dispatch_groups or 1)


# the recurrent blocks: their full-sequence and one-token functions, and
# the names of their state's leaves in the cache, in the order the
# functions take and return them
_RECURRENT = {"mamba": (L.mamba_apply, L.mamba_decode, ("conv", "ssm")),
              "mlstm": (L.mlstm_apply, L.mlstm_decode, ("C", "n")),
              "slstm": (L.slstm_apply, L.slstm_decode,
                        ("h", "c", "sn", "m"))}


def _apply_slot_full(cfg, sp, kind, is_moe, has_ffn, x, rope_cs, enc_out,
                     collect_cache):
    """Returns (x, aux or None, cache or None).  With ``enc_out`` (an
    encoder-decoder's), the cross block runs after the mixer; without it
    (a Fig.-5 stage after the first, fed ``(syn, None)``) it is left out,
    as in the reference."""
    cache = {}
    h = L.norm_apply(sp["norm1"], x)
    if kind == "attn":
        out, (k, v) = L.attention_apply(sp["attn"], h, cfg, rope_cs=rope_cs,
                                        causal=True,
                                        window=cfg.sliding_window)
        if collect_cache:
            cache["k"], cache["v"] = k, v
    else:
        apply, _, leaves = _RECURRENT[kind]
        out, st = apply(sp[kind], h, cfg)
        if collect_cache:
            cache.update(zip(leaves, st))
    x = L.residual_add(x, out)
    if cfg.enc_dec and enc_out is not None:
        out, (ck, cv) = L.attention_apply(sp["cross"],
                                          L.norm_apply(sp["norm_x"], x), cfg,
                                          kv_override=enc_out)
        x = L.residual_add(x, out)
        if collect_cache:
            cache["cross_k"], cache["cross_v"] = ck, cv
    aux = None
    if has_ffn:
        out, aux = _ffn(cfg, sp, is_moe, L.norm_apply(sp["norm2"], x))
        x = L.residual_add(x, out)
    return x, aux, (cache if collect_cache else None)


def _group_body(cfg, slots, pgroup, x, lb, z, rope_cs, enc_out,
                collect_cache=False):
    """One group's slots over x; the MoE slots' aux terms are added to the
    running (lb, z), slot by slot, as the reference's scan carry does.
    Returns (x, lb, z, {slot_i: cache or None})."""
    cache_g = {}
    for i, (kind, is_moe, has_ffn) in enumerate(slots):
        x, aux, cache = _apply_slot_full(cfg, pgroup[f"slot_{i}"], kind,
                                         is_moe, has_ffn, x, rope_cs,
                                         enc_out, collect_cache)
        if aux is not None:
            lb = lb + aux["lb_loss"]
            z = z + aux["z_loss"]
        cache_g[f"slot_{i}"] = cache
    return x, lb, z, cache_g


def _needs_grad(x, pgroup) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in tree_leaves(pgroup)))


def forward_groups(cfg, groups_params: List[dict], x, *, rope_cs,
                   enc_out=None, g0=0, g1=None, collect_cache=False,
                   remat=True):
    """Runs groups [g0, g1) over x (``rope_cs`` None: no rope; ``enc_out``:
    the encoder output an encoder-decoder's cross blocks read).  Returns
    (x, aux, cache or None): aux {"lb_loss", "z_loss"} sums the MoE slots'
    terms over the layers (fp32 zeros without experts); the cache is
    stacked over groups: {slot_i: {leaf: (G, B, ...)}}, with "k"/"v"
    (B, S, KV, hd) for attention slots (and "cross_k"/"cross_v"
    (B, enc_seq, KV, hd) with ``enc_out``), "conv"/"ssm" for Mamba
    slots, "C" (B, H, dh, dh) / "n" (B, H, dh) for mLSTM slots and
    "h"/"c"/"sn"/"m" (B, d) for sLSTM slots, the states fp32.

    ``remat``: each group whose activations autograd needs runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward, so a
    group keeps only its input alive (the reference's ``jax.checkpoint``
    of the group body).  Without grad, or when collecting the cache, the
    groups run plainly."""
    slots = slot_spec(cfg)
    g1 = n_groups(cfg) if g1 is None else g1
    lb = z = torch.zeros((), dtype=torch.float32, device=x.device)
    per_group = []
    for pgroup in groups_params[g0:g1]:
        if remat and not collect_cache and _needs_grad(x, pgroup):
            x, lb, z, _ = checkpoint(_group_body, cfg, slots, pgroup, x,
                                     lb, z, rope_cs, enc_out,
                                     use_reentrant=False)
            continue
        x, lb, z, cache_g = _group_body(cfg, slots, pgroup, x, lb, z,
                                        rope_cs, enc_out, collect_cache)
        per_group.append(cache_g)
    aux = {"lb_loss": lb, "z_loss": z}
    if not collect_cache:
        return x, aux, None
    caches = {}
    for i in range(len(slots)):
        sk = f"slot_{i}"
        caches[sk] = {n: torch.stack([c[sk][n] for c in per_group])
                      for n in per_group[0][sk]}
    return x, aux, caches


def forward(cfg, params, batch, *, remat=True):
    """Training forward of the whole network: returns (logits, aux)."""
    x, enc_out, n_prefix = embed_inputs(cfg, params, batch)
    rope_cs = rope_for(cfg, torch.arange(x.shape[1], device=x.device))
    x, aux, _ = forward_groups(cfg, params["groups"], x, rope_cs=rope_cs,
                               enc_out=enc_out, remat=remat)
    x = norm_apply_final(cfg, params, x)
    aux["n_prefix"] = n_prefix
    return unembed(cfg, params, x), aux


def norm_apply_final(cfg, params, x):
    return L.norm_apply(params["final_norm"], x)


def unembed(cfg, params, x):
    if cfg.tie_embeddings:
        w = L.as_dtype(params["tok_embed"], x.dtype).T
    else:
        w = L.as_dtype(params["unembed"], x.dtype)
    return x @ w


# --------------------------------------------------------------------------
# caches / prefill / decode
# --------------------------------------------------------------------------

def cache_len_for(cfg, cache_len: int) -> int:
    return min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len


# the value a cache leaf starts at where it is not 0: sLSTM's stabiliser
CACHE_FILL = {"m": -1e9}


def init_cache(cfg, batch_size, cache_len, *, device):
    """Cache stacked over groups: attention slots {"k", "v":
    (G, B, Lc, KV, hd)} in cfg.dtype, and for an encoder-decoder {"cross_k",
    "cross_v": (G, B, enc_seq, KV, hd)}; Mamba slots {"conv":
    (G, B, K-1, Di)} in cfg.dtype and {"ssm": (G, B, Di, N)} in fp32;
    mLSTM slots {"C": (G, B, H, dh, dh), "n": (G, B, H, dh)} and sLSTM
    slots {"h", "c", "sn", "m": (G, B, d)}, fp32.  Every leaf is zeros but
    sLSTM's "m", at -1e9 (``CACHE_FILL``), as the reference's.
    ``device`` has no default: a cache is never placed on the CPU by
    omission."""
    dtype = cfg.activation_dtype()
    g = n_groups(cfg)
    lc = cache_len_for(cfg, cache_len)
    cache = {}
    for i, (kind, _, _) in enumerate(slot_spec(cfg)):
        if kind == "attn":
            shapes = {n: ((g, batch_size, lc, cfg.n_kv_heads, cfg.hd), dtype)
                      for n in ("k", "v")}
            if cfg.enc_dec:
                shapes.update({n: ((g, batch_size, cfg.enc_seq,
                                    cfg.n_kv_heads, cfg.hd), dtype)
                               for n in ("cross_k", "cross_v")})
        elif kind == "mamba":
            d_in, _, n, d_conv = L.mamba_dims(cfg)
            shapes = {"conv": ((g, batch_size, d_conv - 1, d_in), dtype),
                      "ssm": ((g, batch_size, d_in, n), torch.float32)}
        elif kind == "mlstm":
            hn = cfg.n_heads
            dh = int(cfg.xlstm.proj_factor * cfg.d_model) // hn
            shapes = {"C": ((g, batch_size, hn, dh, dh), torch.float32),
                      "n": ((g, batch_size, hn, dh), torch.float32)}
        else:
            shapes = {n: ((g, batch_size, cfg.d_model), torch.float32)
                      for n in ("h", "c", "sn", "m")}
        cache[f"slot_{i}"] = {
            name: torch.full(shape, CACHE_FILL.get(name, 0.0), dtype=dt,
                             device=device)
            for name, (shape, dt) in shapes.items()}
    return cache


def _ring_pack(k, lc, window):
    """Pack full-seq keys (B,S,KV,hd) into a cache of length lc: with a
    window, the key at absolute pos p lands at slot p % lc (the decode ring
    layout); otherwise the first lc keys land at their pos."""
    s = k.shape[1]
    if s <= lc:
        return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, lc - s))
    tail = k[:, -lc:]
    if not window:
        return tail.contiguous()
    slots = torch.arange(s - lc, s, device=k.device) % lc
    out = torch.zeros((k.shape[0], lc) + tuple(k.shape[2:]), dtype=k.dtype,
                      device=k.device)
    out[:, slots] = tail
    return out


def repack_prefill_cache(cfg, caches, cache_len):
    """Repack the stacked full-seq prefill K/V into fixed cache slots (ring
    layout when a sliding window is set); carry states and the cross K/V
    pass through unchanged."""
    lc = cache_len_for(cfg, cache_len)
    w = cfg.sliding_window
    return {sk: {n: (torch.stack([_ring_pack(t, lc, w) for t in leaf])
                     if n in ("k", "v") else leaf)
                 for n, leaf in c.items()}
            for sk, c in caches.items()}


def prefill(cfg, params, batch, cache_len):
    """Forward over the prompt, building the decode cache.
    Returns (last_token_logits (B,V), cache, next_pos int)."""
    x, enc_out, _ = embed_inputs(cfg, params, batch)
    s = x.shape[1]
    rope_cs = rope_for(cfg, torch.arange(s, device=x.device))
    x, _, caches = forward_groups(cfg, params["groups"], x, rope_cs=rope_cs,
                                  enc_out=enc_out, collect_cache=True)
    cache = repack_prefill_cache(cfg, caches, cache_len)
    xl = L.norm_apply(params["final_norm"], x[:, -1:])
    logits = unembed(cfg, params, xl)[:, 0]
    return logits, cache, s


def decode_embed(cfg, params, token, pos):
    """Embed the current tokens (B,); returns (x (B,1,d), rope_cs).
    pos: int or (B,) int tensor.  An encoder-decoder adds ``dec_pos[pos]``
    (a position past the table reads its last row, as the reference's
    gather clamps) and has no rope (rope_cs None)."""
    dtype = cfg.activation_dtype()
    x = embed_tokens(cfg, params, token[:, None], dtype)
    pos_t = torch.as_tensor(pos, device=token.device)
    if cfg.enc_dec:
        table = L.as_dtype(params["dec_pos"], dtype)
        pe = table[pos_t.long().clamp(0, table.shape[0] - 1)]
        return x + (pe[None, None] if pos_t.dim() == 0 else pe[:, None]), \
            None
    rope_cs = L.rope_tables(pos_t[None] if pos_t.dim() == 0 else pos_t,
                            cfg.hd, cfg.rope_fraction, cfg.rope_theta)
    return x, rope_cs


def decode_groups(cfg, groups_params, cache, x, rope_cs, pos, paged=None):
    """One decode step over the layer groups; the cache (stacked over the
    same groups) is updated in place.  With ``paged``, the K/V leaves are
    (G, NB, BS, KV, hd) block pools routed by one shared block table; the
    recurrent states (Mamba, mLSTM, sLSTM) and an encoder-decoder's cross
    K/V stay slot-resident and ignore it (the cross-attention reads every
    one of its enc_seq slots and writes none).  Returns (x, cache)."""
    slots = slot_spec(cfg)
    window = cfg.sliding_window
    for g, pgroup in enumerate(groups_params):
        for i, (kind, is_moe, has_ffn) in enumerate(slots):
            sp = pgroup[f"slot_{i}"]
            c = cache[f"slot_{i}"]
            h = L.norm_apply(sp["norm1"], x)
            if kind == "attn":
                out, _ = L.attention_decode(sp["attn"], h, cfg,
                                            (c["k"][g], c["v"][g]), pos,
                                            rope_cs=rope_cs, window=window,
                                            paged=paged)
            else:
                _, decode, leaves = _RECURRENT[kind]
                out, st = decode(sp[kind], h, cfg,
                                 tuple(c[n][g] for n in leaves))
                for n, t in zip(leaves, st):
                    c[n][g].copy_(t)
            x = L.residual_add(x, out)
            if cfg.enc_dec:
                out, _ = L.attention_decode(
                    sp["cross"], L.norm_apply(sp["norm_x"], x), cfg, None,
                    pos, cross_kv=(c["cross_k"][g], c["cross_v"][g]))
                x = L.residual_add(x, out)
            if not has_ffn:
                continue
            # the MoE aux terms are dropped; every slot of the batch, live
            # or free, takes part in routing and capacity
            out, _ = _ffn(cfg, sp, is_moe, L.norm_apply(sp["norm2"], x))
            x = L.residual_add(x, out)
    return x, cache


def decode_step(cfg, params, cache, token, pos, paged=None):
    """One decode step. token: (B,) int; pos: int or (B,) int tensor.
    paged: optional ``(block_tables, logical_len)``.  The cache is updated
    in place.  Returns (logits (B,V), cache)."""
    x, rope_cs = decode_embed(cfg, params, token, pos)
    x, cache = decode_groups(cfg, params["groups"], cache, x, rope_cs, pos,
                             paged=paged)
    x = L.norm_apply(params["final_norm"], x)
    return unembed(cfg, params, x)[:, 0], cache


__all__ = ["group_size", "slot_spec", "n_groups", "init_params",
           "compute_copy", "embed_tokens", "sinusoidal", "encode_audio",
           "embed_inputs", "forward_groups",
           "forward", "norm_apply_final", "rope_for", "unembed", "init_cache", "repack_prefill_cache", "prefill",
           "decode_embed", "decode_groups", "decode_step"]
