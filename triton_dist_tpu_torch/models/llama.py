"""Llama-style decoder: the differentiable full-sequence forward (training),
its tensor-parallel twin over the overlap ops (``forward_tp_overlap``), the
contiguous-cache decode (``decode_step``, its sequence-parallel twin
``decode_step_sp`` and the greedy ``generate``) and the serving half
(prefill, paged decode, chunked paged prefill and the multi-token decode
loop).

Counterpart of ``triton_dist_tpu/models/llama.py`` with its layouts kept:
parameters are a dict of stacked per-layer tensors (leading ``L`` dim), and a
projection weight is ``[in, out]`` applied as ``x @ w``. PyTorch runs
eagerly, so the layer loop and the horizon loop are Python loops over device
tensors; neither syncs with the host.

The JAX functions are pure and return new caches and pools. Here the KV
cache and the page pool are updated in place (the JAX serving engine donates
them, so it updates them in place too) and returned for symmetry.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from triton_dist_tpu_torch.ops.allgather_gemm import ag_gemm
from triton_dist_tpu_torch.ops.autodiff import ag_gemm_diff, gemm_rs_diff
from triton_dist_tpu_torch.ops.flash_decode import (gqa_decode_paged,
                                                    gqa_decode_partial,
                                                    paged_kv_write,
                                                    sp_gqa_flash_decode)
from triton_dist_tpu_torch.ops.gemm import GemmConfig
from triton_dist_tpu_torch.ops.gemm_reduce_scatter import gemm_rs
from triton_dist_tpu_torch.utils.env import default_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 11008
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    max_seq_len: int = 4096
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def llama_7b(cls):
        return cls()

    @classmethod
    def llama3_8b(cls):
        return cls(vocab_size=128256, d_model=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, d_ff=14336, rope_theta=5e5)

    @classmethod
    def llama3_70b(cls):
        return cls(vocab_size=128256, d_model=8192, n_layers=80, n_heads=64,
                   n_kv_heads=8, d_ff=28672, rope_theta=5e5)

    @classmethod
    def llama3_405b(cls):
        return cls(vocab_size=128256, d_model=16384, n_layers=126,
                   n_heads=128, n_kv_heads=8, d_ff=53248, rope_theta=5e5)

    @classmethod
    def mistral_7b(cls):
        return cls(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, d_ff=14336)

    @classmethod
    def qwen2_72b(cls):
        return cls(vocab_size=152064, d_model=8192, n_layers=80, n_heads=64,
                   n_kv_heads=8, d_ff=29568)

    @classmethod
    def tiny(cls, n_layers: int = 2):
        """Test config: a few narrow layers."""
        return cls(vocab_size=512, d_model=128, n_layers=n_layers, n_heads=4,
                   n_kv_heads=2, d_ff=256, max_seq_len=128)


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``:
    scaled normals in ``cfg.dtype``, norm gains of one in f32. The same keys
    and shapes as the JAX ``init_params``; the numbers differ (another
    generator), so a cross-framework test converts the JAX ones instead
    (``models.convert.params_from_jax``)."""
    dev = default_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, D, Fd = cfg.n_layers, cfg.d_model, cfg.d_ff
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def norm(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).mul_(0.02).to(cfg.dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    out_scale = math.sqrt(2 * L)
    return {
        "embed": norm(cfg.vocab_size, D),
        "blocks": {
            "attn_norm": ones(L, D),
            "wq": norm(L, D, Hq * Dh),
            "wk": norm(L, D, Hkv * Dh),
            "wv": norm(L, D, Hkv * Dh),
            "wo": norm(L, Hq * Dh, D) / out_scale,
            "mlp_norm": ones(L, D),
            "w_gate": norm(L, D, Fd),
            "w_up": norm(L, D, Fd),
            "w_down": norm(L, Fd, D) / out_scale,
        },
        "final_norm": ones(D),
        "lm_head": norm(D, cfg.vocab_size),
    }


# ---------------------------------------------------------------------------
# math building blocks
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps: float):
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return ((x32 * rms) * w).to(x.dtype)


def rope(x, positions, theta: float):
    """x [..., S, H, Dh]; positions [..., S]. Half-split RoPE, angles in
    f32."""
    half = x.shape[-1] // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    angles = positions[..., None].float() * freqs             # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                  # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _attention(q, k, v, sm_scale: float, kv_len=None):
    """Causal GQA attention. q [B,S,Hq,Dh]; k,v [B,S,Hkv,Dh]. ``kv_len`` [B]
    (optional) also masks keys at or after each row's length (the bucketed-
    prefill guard against padded positions), with the same -1e30 fill. Scores
    and the P.V product accumulate in f32; p is cast to v's type first."""
    B, S, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, Dh).float()
    scores = torch.einsum("bshgd,bthd->bhgst", qg, k.float()) * sm_scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    mask = mask[None, None, None]
    if kv_len is not None:
        valid = torch.arange(S, device=q.device)[None] < kv_len[:, None]
        mask = mask & valid[:, None, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, S, Hq, Dh).to(q.dtype)


def _ffn(h, p):
    gate = F.silu((h @ p["w_gate"]).float()).to(h.dtype)
    return (gate * (h @ p["w_up"])) @ p["w_down"]


def _layer(params: dict, i: int) -> dict:
    return {name: w[i] for name, w in params["blocks"].items()}


def _plain_linear(h, w, name):
    return h @ w


def _head(params: dict, x, cfg: LlamaConfig, linear=None):
    """Final norm and LM head: logits in the working type, then f32, the
    same rounding point as the JAX model (argmax ties resolve alike).
    ``linear(h, w, name)`` replaces the product, as in the paged model
    functions."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (linear or _plain_linear)(x, params["lm_head"], "lm_head").float()


# ---------------------------------------------------------------------------
# full-sequence forward (training)
# ---------------------------------------------------------------------------

def block_apply(cfg: LlamaConfig, x, p: dict, positions, attn_fn=None):
    """One transformer block. x [B, S, D]; ``p`` one layer's weights.
    ``attn_fn(q, k, v, sm_scale)`` replaces the dense attention (the ring
    attention kernel under the cp plan, ``parallel.train``). Nothing that
    autograd saves is updated in place. The JAX ``act_spec`` sharding pins
    have no counterpart on one card."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
    q = rope((h @ p["wq"]).view(B, S, Hq, Dh), positions, cfg.rope_theta)
    k = rope((h @ p["wk"]).view(B, S, Hkv, Dh), positions, cfg.rope_theta)
    v = (h @ p["wv"]).view(B, S, Hkv, Dh)
    attn = (attn_fn or _attention)(q, k, v, 1.0 / math.sqrt(Dh))
    x = x + attn.reshape(B, S, Hq * Dh) @ p["wo"]
    h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
    return x + _ffn(h, p)


def forward(params: dict, tokens, cfg: LlamaConfig, remat: bool = False,
            attn_fn=None):
    """Full-sequence forward: logits [B, S, V] f32, differentiable.

    The stacked layer weights are split with one ``unbind`` each, so the
    backward stacks each weight's per-layer gradients once (a ``w[i]``
    select per layer would build a full-size gradient per layer).
    ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``, the JAX ``jax.checkpoint`` of the scanned
    body)."""
    B, S = tokens.shape
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    names = list(params["blocks"])
    per_layer = zip(*(params["blocks"][n].unbind(0) for n in names))
    for ws in per_layer:
        p = dict(zip(names, ws))
        if remat:
            x = checkpoint(block_apply, cfg, x, p, positions, attn_fn,
                           use_reentrant=False)
        else:
            x = block_apply(cfg, x, p, positions, attn_fn)
    return _head(params, x, cfg)


# ---------------------------------------------------------------------------
# hand-overlapped tensor-parallel forward
# ---------------------------------------------------------------------------

def _tile(m: int, n: int) -> GemmConfig:
    """The largest power-of-two tiles up to 128 that divide [m, n]."""
    return GemmConfig(math.gcd(128, m), math.gcd(128, n))


def mlp_tp_overlap(ctx, x2d, w_gate, w_up, w_down, axis=None,
                   gemm_cfg=None):
    """The Llama MLP over the differentiable overlap ops, for the Megatron
    sequence-parallel layout: x2d [T, D] sharded on rows -> [T, D] sharded
    on rows, over ``axis`` (a name: the whole mesh or a group inside it; or
    a tuple of axes, outer first: the 2-tier forms). Gate and up run as
    one AG-GEMM over the per-shard [gate_i ‖ up_i] interleave (at one rank
    the concatenation [w_gate ‖ w_up], built per call), the down projection
    as its GEMM-RS adjoint; both are autograd functions whose backward is
    the other op (``ops.autodiff``)."""
    axis = axis or ctx.axis_names[0]
    n = ctx.axis_size(axis)
    D, Fd = w_gate.shape
    T_local = x2d.shape[0] // n
    if gemm_cfg is not None:
        cfg_ag = cfg_rs = gemm_cfg
    else:
        cfg_ag = _tile(T_local, 2 * (Fd // n))
        cfg_rs = _tile(T_local, D)
    wf = torch.cat([w_gate.reshape(D, n, Fd // n),
                    w_up.reshape(D, n, Fd // n)], dim=2).reshape(D, 2 * Fd)
    h2 = ag_gemm_diff(ctx, axis, cfg_ag, x2d, wf).reshape(-1, n,
                                                          2 * (Fd // n))
    gate, up = h2[..., :Fd // n], h2[..., Fd // n:]
    ff = (F.silu(gate.float()).to(x2d.dtype) * up).reshape(-1, Fd)
    return gemm_rs_diff(ctx, axis, cfg_rs, ff, w_down)


def forward_tp_overlap(ctx, params: dict, tokens, cfg: LlamaConfig,
                       axis=None):
    """Full-sequence forward where every Megatron linear pair runs through
    the overlap ops: qkv and gate‖up through AG-GEMM, o and down through
    GEMM-RS (the model-level composition of the reference's tutorials 07
    and 08). The fused [wq ‖ wk ‖ wv] is built per call, interleaved by
    rank, so that at n ranks rank r's column block of the qkv output holds
    its heads. The ops return the JAX package's global views (column blocks
    by rank from AG-GEMM, row blocks by rank from GEMM-RS), so the code is
    the same at any n and over any ``axis``: a name (the whole mesh or a
    group inside it) or a tuple of axes, outer first (the 2-tier forms, the
    ranks in ``P(axes)`` order), which it only passes down. tokens [B, S];
    returns logits [B, S, V] f32 (the LM head is a plain product, as in the
    JAX model)."""
    axis = axis or ctx.axis_names[0]
    nr = ctx.axis_size(axis)
    B, S = tokens.shape
    D = cfg.d_model
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    T = B * S
    qw, kw = Hq * Dh // nr, Hkv * Dh // nr
    xs = x.reshape(T, D)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        h = rmsnorm(xs, p["attn_norm"], cfg.norm_eps)
        wqkv = torch.cat([p["wq"].reshape(D, nr, qw),
                          p["wk"].reshape(D, nr, kw),
                          p["wv"].reshape(D, nr, kw)], dim=2).reshape(D, -1)
        qkv = ag_gemm(ctx, h, wqkv, axis=axis,
                      cfg=_tile(T // nr, wqkv.shape[1] // nr)
                      ).reshape(T, nr, qw + 2 * kw)
        q = rope(qkv[..., :qw].reshape(B, S, Hq, Dh), positions,
                 cfg.rope_theta)
        k = rope(qkv[..., qw:qw + kw].reshape(B, S, Hkv, Dh), positions,
                 cfg.rope_theta)
        v = qkv[..., qw + kw:].reshape(B, S, Hkv, Dh)
        attn = _attention(q, k, v, 1.0 / math.sqrt(Dh))
        xs = xs + gemm_rs(ctx, attn.reshape(T, Hq * Dh), p["wo"], axis=axis,
                          cfg=_tile(T // nr, D))
        h = rmsnorm(xs, p["mlp_norm"], cfg.norm_eps)
        xs = xs + mlp_tp_overlap(ctx, h, p["w_gate"], p["w_up"], p["w_down"],
                                 axis=axis)
    return _head(params, xs.reshape(B, S, D), cfg)


# ---------------------------------------------------------------------------
# contiguous cache + bucketed prefill
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LlamaConfig, batch: int, max_seq: int,
                  device="cuda") -> dict:
    """Head-major contiguous cache ``[L, B, Hkv, S, D]``."""
    dev = default_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def shard_kv_cache(cache: dict, n: int) -> dict:
    """A contiguous cache ``[L, B, Hkv, S, D]`` in the sequence-parallel
    layout of n ranks, ``[L, n, B, Hkv, S / n, D]``: rank r's shard holds
    slots ``r * S / n .. (r + 1) * S / n`` and is contiguous, so each layer
    of each decode step reads it in place (the JAX cache is sharded on S
    with ``P(None, None, None, axis, None)``). A copy, made once at the
    edge (after ``prefill``)."""
    def shard(t):
        L, B, H, S, D = t.shape
        if S % n:
            raise ValueError(f"{S} slots do not split over {n} ranks")
        return t.view(L, B, H, n, S // n, D).permute(0, 3, 1, 2, 4, 5) \
            .contiguous()
    return {name: shard(t) for name, t in cache.items()}


def prefill(params: dict, tokens, cfg: LlamaConfig, cache: dict,
            length=None):
    """Full-sequence forward that also writes K/V into ``cache[:, :, :, :S]``
    (in place). Returns (last-position logits [B, V] f32, cache).

    ``length`` [B] (optional) is each row's valid prompt length when
    ``tokens`` is padded to a bucket: the attention masks the padded tail and
    the logits are taken at ``length - 1``."""
    B, S = tokens.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        q = rope((h @ p["wq"]).view(B, S, Hq, Dh), positions, cfg.rope_theta)
        k = rope((h @ p["wk"]).view(B, S, Hkv, Dh), positions, cfg.rope_theta)
        v = (h @ p["wv"]).view(B, S, Hkv, Dh)
        cache["k"][i, :, :, :S] = k.transpose(1, 2)
        cache["v"][i, :, :, :S] = v.transpose(1, 2)
        attn = _attention(q, k, v, 1.0 / math.sqrt(Dh), kv_len=length)
        x = x + attn.reshape(B, S, Hq * Dh) @ p["wo"]
        h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(h, p)
    if length is None:
        last = x[:, -1]
    else:
        last = x[torch.arange(B, device=x.device), length.long() - 1]
    return _head(params, last, cfg), cache


# ---------------------------------------------------------------------------
# contiguous-cache decode and greedy generation
# ---------------------------------------------------------------------------

def _decode_layers(params: dict, token, pos, cfg: LlamaConfig, cache: dict,
                   attend, ffn):
    """One-token decode at the scalar position ``pos`` over the contiguous
    cache: each layer writes its new (k, v) row into slot ``pos`` in place
    (``cache[i, :, :, pos]``; in the sequence-parallel layout, slot ``pos %
    S_local`` of the rank that owns ``pos``) and attends with ``attend(q,
    ck, cv, kv_len)`` at ``kv_len = pos + 1``. Returns (logits [B, V] f32,
    cache)."""
    B = token.shape[0]
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = int(pos)
    x = params["embed"][token].to(cfg.dtype)                 # [B, D]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    kv_len = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        q = rope((h @ p["wq"]).view(B, 1, Hq, Dh), positions,
                 cfg.rope_theta)[:, 0]                       # [B, Hq, Dh]
        k = rope((h @ p["wk"]).view(B, 1, Hkv, Dh), positions,
                 cfg.rope_theta)[:, 0]                       # [B, Hkv, Dh]
        v = (h @ p["wv"]).view(B, Hkv, Dh)
        ck, cv = cache["k"][i], cache["v"][i]   # [(n,) B, Hkv, S(/n), Dh]
        if ck.dim() == 4:
            ck[:, :, pos] = k
            cv[:, :, pos] = v
        else:
            s_local = ck.shape[3]
            ck[pos // s_local, :, :, pos % s_local] = k
            cv[pos // s_local, :, :, pos % s_local] = v
        attn = attend(q, ck, cv, kv_len)
        x = x + attn.reshape(B, Hq * Dh) @ p["wo"]
        h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
        x = x + (_ffn if ffn is None else ffn)(h, p).to(x.dtype)
    return _head(params, x, cfg), cache


def decode_step(params: dict, token, pos, cfg: LlamaConfig, cache: dict,
                ffn=None):
    """One-token decode over the contiguous cache from ``init_kv_cache``.

    ``token`` [B] int32; ``pos`` an int (or 0-d tensor): the cache slots
    filled so far, the same for every row. The new (k, v) row is written
    into the cache at ``pos`` in place (the JAX version's
    ``dynamic_update_slice``), and attention is ``gqa_decode_partial`` at
    ``kv_len = pos + 1``. ``ffn(h, p) -> [B, D]`` replaces the dense FFN of
    every layer. Returns (logits [B, V] f32, cache)."""
    def attend(q, ck, cv, kv_len):
        return gqa_decode_partial(q, ck, cv, kv_len)[0]

    return _decode_layers(params, token, pos, cfg, cache, attend, ffn)


def decode_step_sp(ctx, params: dict, token, pos, cfg: LlamaConfig,
                   cache: dict, axis=None,
                   ag_method: str = "fused", ffn=None,
                   replica_checks: list | None = None):
    """``decode_step`` with sequence-parallel attention
    (``sp_gqa_flash_decode``: each rank's partial over its KV shard, the
    partial all-gather and the lse merge) over ``axis`` of ``ctx``: one
    mesh axis (in a multi-axis mesh, each group along it apart, every group
    computing the same step) or a tuple of axes, flattened major to minor
    (``ag_method`` ``push_2d``, ``ring_2d`` or ``auto``). At one rank the
    cache is ``init_kv_cache``'s and the merge of one partial keeps its
    bits, so the logits equal ``decode_step``'s bit for bit. At n ranks
    along ``axis`` the cache is sharded on S (``shard_kv_cache``),
    the new token's (k, v) lands in the shard that owns ``pos``, and the
    rest of the layer (weights replicated) runs once on rank 0's replica of
    the attention. With
    ``replica_checks`` a list, each layer appends a 0-d bool tensor: whether
    every rank's replica equals rank 0's bit for bit (no synchronisation)."""
    def attend(q, ck, cv, kv_len):
        rep = sp_gqa_flash_decode(ctx, q, ck, cv, kv_len, axis=axis,
                                  ag_method=ag_method, replicas=True)
        if replica_checks is not None:
            replica_checks.append((rep == rep[:1]).all())
        return rep[0]

    return _decode_layers(params, token, pos, cfg, cache, attend, ffn)


def generate(params: dict, prompt, cfg: LlamaConfig, max_new_tokens: int,
             max_seq: int | None = None):
    """Greedy generation: ``prefill`` of the prompt [B, S0] into a fresh
    contiguous cache of ``max_seq`` slots, then a loop of ``decode_step``.
    Returns the tokens [B, max_new_tokens] int32; the first column is the
    prefill's argmax, as in the JAX version. The JAX scan also runs one
    decode step whose token it drops; this loop stops before it, so it runs
    ``max_new_tokens - 1`` decode steps."""
    B, S0 = prompt.shape
    max_seq = max_seq or cfg.max_seq_len
    assert S0 + max_new_tokens <= max_seq
    cache = init_kv_cache(cfg, B, max_seq, device=prompt.device)
    logits, cache = prefill(params, prompt, cfg, cache)
    tok = logits.argmax(-1).to(torch.int32)
    toks = [tok]
    for i in range(max_new_tokens - 1):
        logits, cache = decode_step(params, tok, S0 + i, cfg, cache)
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
    return torch.stack(toks, dim=1)


# ---------------------------------------------------------------------------
# paged serving path
# ---------------------------------------------------------------------------

def init_page_pool(cfg: LlamaConfig, num_pages: int, page_size: int,
                   device="cuda") -> dict:
    """Paged KV pool ``[L, P, Hkv, page_size, D]``; each page is the slice
    ``gqa_decode_paged`` reads by block-table index. Page accounting is the
    serving runtime's (``serving.kv_pool.KVPagePool``)."""
    assert page_size % 8 == 0, f"page_size {page_size} must be 8-aligned"
    dev = default_device(device)
    shape = (cfg.n_layers, num_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _paged_attention(q, k, v, kp, vp, bt, pos, kv_len, active):
    """The default KV-write and attention pair of the paged model
    functions: ``paged_kv_write`` then ``gqa_decode_paged``."""
    paged_kv_write(kp, vp, k, v, bt, pos, active=active)
    return gqa_decode_paged(q, kp, vp, bt, kv_len)[0], kp, vp


def _paged_layers(params: dict, x, positions, pos, kv_len, cfg: LlamaConfig,
                  pages: dict, bt, active, ffn, attn_io, linear):
    """The layer loop of the paged model functions over rows x [R, D]: each
    layer's projections (``linear``), RoPE at ``positions``, the KV write
    and attention (``attn_io``), and the FFN (``ffn``)."""
    R = x.shape[0]
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lin = linear or _plain_linear
    attend = attn_io or _paged_attention
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        h = rmsnorm(x, p["attn_norm"], cfg.norm_eps)
        q = rope(lin(h, p["wq"], "wq").view(R, 1, Hq, Dh), positions,
                 cfg.rope_theta)[:, 0]                       # [R, Hq, Dh]
        k = rope(lin(h, p["wk"], "wk").view(R, 1, Hkv, Dh), positions,
                 cfg.rope_theta)[:, 0]                       # [R, Hkv, Dh]
        v = lin(h, p["wv"], "wv").view(R, Hkv, Dh)
        kp, vp = pages["k"][i], pages["v"][i]
        attn, kp2, vp2 = attend(q, k, v, kp, vp, bt, pos, kv_len, active)
        if kp2.data_ptr() != kp.data_ptr() or vp2.data_ptr() != vp.data_ptr():
            raise ValueError("attn_io must update the layer's pools in place "
                             "and return them")
        x = x + lin(attn.reshape(R, Hq * Dh), p["wo"], "wo")
        h = rmsnorm(x, p["mlp_norm"], cfg.norm_eps)
        x = x + (_ffn if ffn is None else ffn)(h, p).to(x.dtype)
    return x


def decode_step_paged(params: dict, token, pos, cfg: LlamaConfig,
                      pages: dict, block_table, active=None,
                      sample: bool = False, ffn=None, attn_io=None,
                      linear=None):
    """One-token decode over the paged pool, every row at its own depth.

    ``token`` [B] and ``pos`` [B] int32 (per-row positions); ``block_table``
    [B, pages_per_seq] int32. Each layer writes the new (k, v) into page
    ``bt[b, pos_b // page_size]`` slot ``pos_b % page_size`` and attends with
    ``gqa_decode_paged`` at ``kv_len = pos + 1``. Parked rows point their
    block-table row at the scratch page 0. ``active`` [B] bool sends frozen
    rows' writes to the scratch page. ``ffn(h, p) -> [B, D]`` replaces the
    dense FFN of every layer (``p`` the layer's weights; MoE serving plugs
    ``models.moe.moe_mlp_ep_overlap`` in here).

    ``attn_io(q, k, v, kp, vp, bt, pos, kv_len, active) -> (attn, kp, vp)``
    replaces the KV write and attention pair of every layer (the long-
    context serving path plugs ``ops.flash_decode.flash_decode_dist`` in
    here); it updates the layer's pools in place and returns them (the JAX
    hook returns new pools). ``linear(h, w, name)`` replaces every dense
    projection (wq/wk/wv/wo/lm_head). With no hook the bits are those of the
    plain path. Returns (logits [B, V] f32, or with ``sample=True`` the
    greedy token [B] int32, and the pages)."""
    x = params["embed"][token].to(cfg.dtype)                 # [B, D]
    positions = pos[:, None]                                 # [B, 1]
    kv_len = (pos + 1).to(torch.int32)
    x = _paged_layers(params, x, positions, pos, kv_len, cfg, pages,
                      block_table, active, ffn, attn_io, linear)
    logits = _head(params, x, cfg, linear)
    if sample:
        return logits.argmax(-1).to(torch.int32), pages
    return logits, pages


def prefill_chunk_paged(params: dict, tokens, start: int, prompt_len: int,
                        cfg: LlamaConfig, pages: dict, block_table, ffn=None,
                        attn_io=None, linear=None):
    """Prefill one fixed-size chunk of a prompt straight into the page pool.

    ``tokens`` [C] int32 is chunk ``[start, start + C)`` of the prompt,
    zero-padded past ``prompt_len``; ``block_table`` [pages_per_seq] int32 is
    the sequence's row. The C tokens run as C rows of the paged decode
    machinery: each writes its KV through ``paged_kv_write`` (padded rows go
    to the scratch page) and attends with ``gqa_decode_paged`` at
    ``kv_len = position + 1`` over every page filled so far, this chunk's
    included. All rows' writes of a layer land before that layer's attention
    reads (one stream, in order). Padded rows run with ``kv_len = 0``.
    ``ffn``, ``attn_io`` and ``linear`` hook the FFN, the KV write and
    attention pair and the projections as in ``decode_step_paged`` (the
    chunk's rows are the batch rows; ``active`` is the padded-tail mask).

    Returns ``(tok, pages)``: ``tok`` is the 0-d int32 greedy token of the
    row at ``prompt_len - 1 - start`` (clamped into the chunk), meaningful
    for the chunk that holds the prompt's last token."""
    C = tokens.shape[0]
    dev = tokens.device
    idx = start + torch.arange(C, dtype=torch.int32, device=dev)
    valid = idx < prompt_len
    zero = torch.zeros_like(idx)
    pos = torch.where(valid, idx, zero)
    kv_len = torch.where(valid, idx + 1, zero)
    bt = block_table[None, :].expand(C, -1).contiguous()
    x = params["embed"][tokens].to(cfg.dtype)                # [C, D]
    x = _paged_layers(params, x, pos[:, None], pos, kv_len, cfg, pages, bt,
                      valid, ffn, attn_io, linear)
    last = min(max(prompt_len - 1 - start, 0), C - 1)
    logits = _head(params, x[last:last + 1], cfg, linear)
    return logits[0].argmax(-1).to(torch.int32), pages


def decode_multistep_paged(params: dict, token, pos, cfg: LlamaConfig,
                           pages: dict, block_table, limit, horizon: int,
                           eos_id: int | None = None, ffn=None, attn_io=None,
                           linear=None):
    """``horizon`` sampled decode steps in one call, with no host sync.

    ``limit`` [B] int32 is each row's step budget for this call (0 for parked
    rows). A row freezes once its step index reaches its limit or it has
    emitted ``eos_id``: its token and position stop advancing and its KV
    writes go to the scratch page. ``ffn``, ``attn_io`` and ``linear`` are
    ``decode_step_paged``'s.
    Returns ``(toks [horizon, B] int32,
    token [B], pos [B], pages)``, where ``toks[i, b]`` is row b's step-i
    token (valid while the row was live) and token/pos are the rows' states
    after the call."""
    assert horizon >= 1
    limit = limit.to(torch.int32)
    stopped = torch.zeros(token.shape, dtype=torch.bool, device=token.device)
    toks = []
    for i in range(horizon):
        act = (i < limit) & ~stopped
        nxt, pages = decode_step_paged(params, token, pos, cfg, pages,
                                       block_table, active=act, sample=True,
                                       ffn=ffn, attn_io=attn_io,
                                       linear=linear)
        token = torch.where(act, nxt, token)
        pos = torch.where(act, pos + 1, pos)
        if eos_id is not None:
            stopped = stopped | (act & (nxt == eos_id))
        toks.append(nxt)
    return torch.stack(toks), token, pos, pages


__all__ = ["LlamaConfig", "init_params", "rmsnorm", "rope", "block_apply",
           "forward", "forward_tp_overlap", "mlp_tp_overlap",
           "init_kv_cache", "prefill", "decode_step",
           "decode_step_sp", "generate", "init_page_pool",
           "decode_step_paged", "prefill_chunk_paged",
           "decode_multistep_paged", "shard_kv_cache"]
