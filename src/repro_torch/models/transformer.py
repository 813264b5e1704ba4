"""Decoder-only LM assembled from a ModelConfig, dispatching per layer on
the five block kinds as the JAX package's ``_apply_block`` does:
attention + MLP (``attn_mlp``), attention + mixture of experts
(``attn_moe``), Mamba2 (``mamba2``), Zamba2's shared attention block
(``hybrid_shared_attn``) and RWKV-6 (``rwkv6``).

Params are a plain dict of tensors, the JAX package's pytree with its
``lax.scan`` over stacked layers written out as a list, one dict per layer:

    {"embed": (V, d), "final_norm": {"scale": (d,)}, "lm_head": (d, V),
     "frontend_proj": (frontend_embed_dim or d, d),
     "shared_attn": {"norm1", "attn", "norm2", "mlp"},
     "layers": [{"norm1": {"scale"}, "attn": {"wq", "wk", "wv", "wo"},
                 "norm2": {"scale"}, "mlp": {"up", "gate", "down"}}, ...]}

an ``attn_moe`` layer holding ``moe`` (``moe.param_specs``) in place of
``mlp``, a ``mamba2`` layer ``{"norm": {"scale"}, "mamba": ...}``
(``ssm.param_specs``), an RWKV-6 layer ``rwkv.param_specs``' flat dict,
and a ``hybrid_shared_attn`` layer an empty dict: Zamba2's shared block
exists once, at the top-level ``shared_attn`` (an attention + MLP block),
and every hybrid position applies those same weights. ``frontend_proj`` is
present only for a config with a stub modality frontend
(``num_prefix_embeddings``: paligemma's patch embeddings, musicgen's
conditioning frames), which projects the precomputed prefix embeddings
into the sequence.

Caches map each cache name to one tensor per layer that has it, in layer
order (``cache_slots``): ``{"k": [...], "v": [...]}`` of ``(B, Hkv,
S_alloc, D)`` for every attention layer, hybrid positions included (each
keeps its own), ``{"conv_x", "conv_B", "conv_C", "ssm"}`` for Mamba2
layers (``ssm`` has their shapes), ``{"wkv", "shift_tm", "shift_cm"}`` for
RWKV-6 layers (``rwkv``), with a leading tenant axis R for a
tenant-stacked cohort. ``models.convert`` maps both to and from the JAX
layout.

Entry points:
    forward_prefill          tokens (B, S) [+ prefix_embeds (B, P, fed)]
                             -> (last-position logits, caches)
    forward_decode           token (B,)    -> (logits (B, V), caches)
    forward_decode_tenants   tokens (R, B) over tenant-stacked params and
                             caches -> (logits (R, B, V), caches): the
                             space-time merged decode step; every projection
                             is one batched product across tenants and each
                             layer's attention (or WKV6 or SSM step) runs
                             once.

Caches are updated in place; the returned caches are the ones passed in
(or freshly allocated, for a fresh prefill).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.config import AttentionKind, BlockKind, ModelConfig
from repro_torch.models import attention, layers, moe, rwkv, ssm

Params = Dict[str, Any]
Caches = Dict[str, List[torch.Tensor]]

ATTENTION_BLOCKS = (BlockKind.ATTN_MLP, BlockKind.ATTN_MOE, BlockKind.HYBRID_SHARED_ATTN)
CACHE_NAMES = {
    BlockKind.ATTN_MLP: ("k", "v"),
    BlockKind.ATTN_MOE: ("k", "v"),
    BlockKind.HYBRID_SHARED_ATTN: ("k", "v"),
    BlockKind.MAMBA2: ssm.CACHE_NAMES,
    BlockKind.RWKV6: rwkv.CACHE_NAMES,
}


def cache_slots(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """Per layer: its cache names and its index in those names' lists.
    Layers are numbered per cache-name tuple, so every attention layer,
    whatever its block kind, has a k/v slot of its own."""
    seen: Dict[Tuple[str, ...], int] = {}
    out = []
    for kind in cfg.layer_pattern:
        names = CACHE_NAMES[kind]
        j = seen.get(names, 0)
        out.append((names, j))
        seen[names] = j + 1
    return out


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; never a silent CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def _torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _tenant_axis(tree: Any) -> Any:
    """Views of a single model's params/caches with a tenant axis of 1."""
    if isinstance(tree, dict):
        return {k: _tenant_axis(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tenant_axis(v) for v in tree]
    return tree.unsqueeze(0)


class Model:
    """Config + device + pure apply functions (params are external).

    ``plain_kernels=True`` runs every kernel's op (attention, the WKV6
    scan) through its plain PyTorch version on any device: the opt-in used
    to hold the kernel path against the plain path on the card.
    """

    def __init__(self, cfg: ModelConfig, device=None, plain_kernels: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _torch_dtype(cfg.dtype)
        self.plain = plain_kernels
        self.blocks = list(cfg.layer_pattern)
        self.kinds = [cfg.attention_kind_at(i) for i in range(cfg.num_layers)]
        self.slots = cache_slots(cfg)
        self.has_attention = any(k in ATTENTION_BLOCKS for k in self.blocks)

    # -------------------------------------------------------------- init
    def _param_specs(self) -> Params:
        """Params tree with (shape, init) or (shape, init, dtype) leaves."""
        cfg = self.cfg
        d = cfg.d_model
        spec: Params = {
            "embed": ((cfg.vocab_size, d), "embed"),
            "final_norm": {"scale": ((d,), "ones")},
        }
        if not cfg.tie_embeddings:
            spec["lm_head"] = ((d, cfg.vocab_size), "dense")
        if cfg.num_prefix_embeddings:
            spec["frontend_proj"] = ((cfg.frontend_embed_dim or d, d), "dense")
        if BlockKind.HYBRID_SHARED_ATTN in self.blocks:
            spec["shared_attn"] = self._block_specs(BlockKind.ATTN_MLP)  # one copy
        spec["layers"] = [self._block_specs(kind) for kind in self.blocks]
        return spec

    def _block_specs(self, kind: BlockKind) -> Params:
        cfg = self.cfg
        d = cfg.d_model
        if kind == BlockKind.RWKV6:
            return rwkv.param_specs(cfg)
        if kind == BlockKind.MAMBA2:
            return {"norm": {"scale": ((d,), "ones")}, "mamba": ssm.param_specs(cfg)}
        if kind == BlockKind.HYBRID_SHARED_ATTN:
            return {}  # the shared block's weights live at params["shared_attn"]
        attn = {k: (s, "zeros" if k.startswith("b") else "dense")
                for k, s in attention.attn_param_shapes(cfg).items()}
        block = {"norm1": {"scale": ((d,), "ones")}, "attn": attn,
                 "norm2": {"scale": ((d,), "ones")}}
        if kind == BlockKind.ATTN_MOE:
            block["moe"] = moe.param_specs(cfg)
        else:
            block["mlp"] = layers.mlp_specs(d, cfg.d_ff, cfg.mlp_gated)
        return block

    def _alloc(self, spec: Any, lead: Tuple[int, ...]) -> Any:
        if isinstance(spec, dict):
            return {k: self._alloc(v, lead) for k, v in spec.items()}
        if isinstance(spec, list):
            return [self._alloc(v, lead) for v in spec]
        shape, dtype = spec[0], (spec[2] if len(spec) > 2 else self.dtype)
        return torch.empty(lead + shape, dtype=dtype, device=self.device)

    def _fill(self, spec: Any, out: Any, index: Tuple, gen: torch.Generator) -> None:
        if isinstance(spec, dict):
            for k in spec:
                self._fill(spec[k], out[k], index, gen)
            return
        if isinstance(spec, list):
            for s, o in zip(spec, out):
                self._fill(s, o, index, gen)
            return
        kind = spec[1]
        target = out[index] if index else out
        if kind == "dense":
            layers.dense_init_(target, gen)
        elif kind == "embed":
            layers.embed_init_(target, gen)
        elif kind == "ones":
            target.fill_(1.0)
        elif kind == "mix":  # RWKV token-shift mix: uniform in [0.25, 0.75)
            layers.uniform_(target, 0.25, 0.75, gen)
        elif kind == "decay_base":  # RWKV decay logit base
            target.fill_(-4.0)
        elif kind in ("bonus", "conv"):  # RWKV's bonus u, Mamba2's conv weights
            layers.normal_(target, 0.1, gen)
        elif kind == "a_log":  # Mamba2's A = -exp(A_log): log of 1..16 over heads
            n = target.shape[-1]
            target.copy_(torch.log(torch.linspace(1.0, 16.0, n, device=target.device)))
        else:
            target.zero_()

    def init(self, generator: torch.Generator) -> Params:
        """Random weights at the JAX package's init scales, from ``generator``."""
        spec = self._param_specs()
        params = self._alloc(spec, ())
        self._fill(spec, params, (), generator)
        return params

    def init_stacked(self, generators: Sequence[torch.Generator]) -> Params:
        """R tenants' weights stacked on a leading axis, filled in place.

        Tenant t's slice equals ``init(generators[t])`` for the same seed,
        without ever holding a second copy of the weights.
        """
        spec = self._param_specs()
        params = self._alloc(spec, (len(generators),))
        for t, gen in enumerate(generators):
            self._fill(spec, params, (t,), gen)
        return params

    # -------------------------------------------------------------- caches
    def init_caches(self, batch: int, seq_len: int, tenants: Optional[int] = None,
                    dtype: Optional[torch.dtype] = None) -> Caches:
        """Zeroed caches per layer, by kind (see the module docstring),
        with a leading tenant axis when ``tenants`` is given. ``dtype``
        overrides the model dtype of the attention, token-shift and conv
        caches; the WKV and SSM states stay float32."""
        cfg = self.cfg
        lead = (batch,) if tenants is None else (tenants, batch)
        dtype = dtype or self.dtype
        out: Caches = {}
        for block, kind in zip(self.blocks, self.kinds):
            if block == BlockKind.RWKV6:
                specs = rwkv.cache_specs(cfg)
            elif block == BlockKind.MAMBA2:
                specs = ssm.cache_specs(cfg)
            else:
                s = attention.cache_alloc_len(cfg, kind, seq_len)
                shape = (cfg.num_kv_heads, s, cfg.head_dim)
                specs = {"k": (shape, None), "v": (shape, None)}
            for name, (shape, dt) in specs.items():
                out.setdefault(name, []).append(
                    torch.zeros(lead + shape, dtype=dt or dtype, device=self.device))
        return out

    def _layer_cache(self, caches: Caches, i: int) -> Dict[str, torch.Tensor]:
        names, j = self.slots[i]
        return {name: caches[name][j] for name in names}

    def _layer_params(self, params: Params, i: int) -> Params:
        if self.blocks[i] == BlockKind.HYBRID_SHARED_ATTN:
            return params["shared_attn"]
        return params["layers"][i]

    def _ffn(self, kind: BlockKind, lp: Params, h: torch.Tensor, tenants: bool) -> torch.Tensor:
        """The FFN half of an attention block: on h (B, S, d) of one model in
        a prefill, or on h (R, B, d) over tenant-stacked weights in a decode
        step, where each of the B sequences holds one token (MoE capacity is
        per sequence; the load-balance loss is dropped, as the reference's
        prefill and decode drop it)."""
        if kind != BlockKind.ATTN_MOE:
            return layers.mlp(lp["mlp"], h, self.cfg.mlp_gated)
        if tenants:
            return moe.moe_forward(lp["moe"], h[:, :, None], self.cfg)[0][:, :, 0]
        return moe.moe_forward(_tenant_axis(lp["moe"]), h[None], self.cfg)[0][0]

    # -------------------------------------------------------------- pieces
    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        scale = params["final_norm"]["scale"]
        x = layers.rmsnorm(scale[..., None, :], x, cfg.norm_eps)
        w = params["embed"].transpose(-1, -2) if cfg.tie_embeddings else params["lm_head"]
        logits = torch.matmul(x, w)
        if cfg.logit_softcap > 0.0:
            logits = cfg.logit_softcap * torch.tanh(logits.float() / cfg.logit_softcap)
        return logits

    def _embed_scale(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.scale_embed:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
        return x

    # -------------------------------------------------------------- entry points
    def forward_prefill(
        self,
        params: Params,
        tokens: torch.Tensor,
        cache_len: int,
        caches: Optional[Caches] = None,
        start: Optional[int] = None,
        *,
        prefix_embeds: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Caches]:
        """Prefill. Returns (last-position logits (B, V), caches).

        Fresh sequences: leave ``caches``/``start`` unset. Chunked
        continuation: pass the previous chunk's caches and the absolute
        position of this chunk's first token (not for sliding-window ring
        caches).

        ``prefix_embeds`` (B, P, frontend_embed_dim or d_model), for a
        config with a stub frontend: the first P positions of the embedded
        sequence become ``prefix_embeds @ frontend_proj`` (their tokens are
        placeholders), as the reference's prefill does. It is keyword-only
        here; the reference takes it fourth, before ``caches``.
        """
        cfg = self.cfg
        B, S = tokens.shape
        x = self._embed_scale(params["embed"][tokens])
        if cfg.num_prefix_embeddings and prefix_embeds is not None:
            pref = torch.matmul(prefix_embeds.to(x.dtype), params["frontend_proj"])
            x = torch.cat([pref, x[:, prefix_embeds.shape[1]:, :]], dim=1)
        fresh = caches is None
        if fresh:
            caches = self.init_caches(B, cache_len)
        start = 0 if start is None else int(start)
        rope = None
        if self.has_attention:
            rope = layers.rope_tables(torch.arange(start, start + S, device=tokens.device),
                                      cfg.head_dim, cfg.rope_theta)
        for i, kind in enumerate(self.blocks):
            lp, c = self._layer_params(params, i), self._layer_cache(caches, i)
            if kind == BlockKind.RWKV6:
                # honours the incoming state: fresh or a continuation alike
                x = rwkv.rwkv_prefill(lp, x, cfg, c, self.plain)
                continue
            if kind == BlockKind.MAMBA2:
                h = layers.rmsnorm(lp["norm"]["scale"], x, cfg.norm_eps)
                y, new = ssm.mamba2_forward(lp["mamba"], h, cfg, None if fresh else c)
                for name, t in new.items():
                    c[name].copy_(t)
                x = x + y
                continue
            h = layers.rmsnorm(lp["norm1"]["scale"], x, cfg.norm_eps)
            if fresh:
                a = attention.attn_prefill(lp["attn"], h, cfg, self.kinds[i], c["k"], c["v"],
                                           rope, self.plain)
            else:
                a = attention.attn_prefill_continue(
                    lp["attn"], h, cfg, self.kinds[i], c["k"], c["v"], start, rope, self.plain)
            x = x + a
            h = layers.rmsnorm(lp["norm2"]["scale"], x, cfg.norm_eps)
            x = x + self._ffn(kind, lp, h, tenants=False)
        logits = self._logits(params, x[:, -1:, :])
        return logits[:, 0, :], caches

    def forward_decode_tenants(
        self,
        params: Params,
        tokens: torch.Tensor,
        caches: Caches,
        lengths: torch.Tensor,
    ) -> Tuple[torch.Tensor, Caches]:
        """One merged decode step for R tenants x B slots.

        params: tenant-stacked (every leaf has a leading R axis); tokens and
        lengths (R, B); caches per layer with a leading (R, B). Returns
        (logits (R, B, V), caches).
        """
        cfg = self.cfg
        R = tokens.shape[0]
        tenant = torch.arange(R, device=tokens.device)[:, None]
        x = self._embed_scale(params["embed"][tenant, tokens])  # (R, B, d)
        rope = None
        if self.has_attention:
            rope = layers.rope_tables(lengths.reshape(-1, 1), cfg.head_dim, cfg.rope_theta)
        for i, kind in enumerate(self.blocks):
            lp, c = self._layer_params(params, i), self._layer_cache(caches, i)
            if kind == BlockKind.RWKV6:
                x = rwkv.rwkv_decode(lp, x, cfg, c)
                continue
            if kind == BlockKind.MAMBA2:
                h = layers.rmsnorm(lp["norm"]["scale"][:, None, :], x, cfg.norm_eps)
                x = x + ssm.mamba2_decode(lp["mamba"], h, cfg, c)
                continue
            h = layers.rmsnorm(lp["norm1"]["scale"][:, None, :], x, cfg.norm_eps)
            x = x + attention.attn_decode(
                lp["attn"], h, cfg, c["k"], c["v"], lengths, rope, self.plain)
            h = layers.rmsnorm(lp["norm2"]["scale"][:, None, :], x, cfg.norm_eps)
            x = x + self._ffn(kind, lp, h, tenants=True)
        return self._logits(params, x), caches

    def forward_decode(
        self,
        params: Params,
        token: torch.Tensor,
        caches: Caches,
        lengths: torch.Tensor,
    ) -> Tuple[torch.Tensor, Caches]:
        """One decode step of one model: token/lengths (B,) -> (logits (B, V), caches)."""
        logits, _ = self.forward_decode_tenants(
            _tenant_axis(params), token[None], _tenant_axis(caches), lengths[None])
        return logits[0], caches


def build_model(cfg: ModelConfig, device=None, plain_kernels: bool = False) -> Model:
    return Model(cfg, device=device, plain_kernels=plain_kernels)
