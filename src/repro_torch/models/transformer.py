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
    forward_train            tokens, labels (B, S) [+ prefix_embeds, loss_mask]
                             -> (loss, {"ce", "aux", "loss"}): differentiable
                             (autograd), with ``remat="block"`` recomputing
                             each block's internals in the backward pass
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
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.utils.checkpoint

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
    scan and state, Mamba2's SSD scan and step) through its plain PyTorch
    version on any device: the opt-in used
    to hold the kernel path against the plain path on the card (in training,
    autograd then differentiates the plain versions).

    remat: "none" | "block". "block" runs each block of ``forward_train``
    under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``
    per block): the backward pass keeps one residual per layer and
    recomputes the rest, so each attention layer's forward kernel runs
    twice a step.
    """

    def __init__(self, cfg: ModelConfig, device=None, plain_kernels: bool = False,
                 remat: str = "block"):
        if remat not in ("none", "block"):
            raise ValueError(f"remat must be 'none' or 'block', got {remat!r}")
        self.cfg = cfg
        self.remat = remat
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

    def _train_block(self, i: int, lp: Params, x: torch.Tensor,
                     rope: Optional[Tuple[torch.Tensor, torch.Tensor]]):
        """Layer i in train mode: (x, its load-balance loss, float32)."""
        cfg = self.cfg
        kind = self.blocks[i]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if kind == BlockKind.RWKV6:
            return rwkv.rwkv_train(lp, x, cfg, self.plain), aux
        if kind == BlockKind.MAMBA2:
            h = layers.rmsnorm(lp["norm"]["scale"], x, cfg.norm_eps)
            # the plain scan: SSD-scan has no backward kernel yet (ROADMAP Queue 2)
            y, _ = ssm.mamba2_forward(lp["mamba"], h, cfg, return_cache=False, plain=True)
            return x + y, aux
        h = layers.rmsnorm(lp["norm1"]["scale"], x, cfg.norm_eps)
        x = x + attention.attn_forward(lp["attn"], h, cfg, self.kinds[i], rope, self.plain)
        h = layers.rmsnorm(lp["norm2"]["scale"], x, cfg.norm_eps)
        if kind == BlockKind.ATTN_MOE:
            y, aux = moe.moe_forward(_tenant_axis(lp["moe"]), h[None], cfg)
            return x + y[0], aux[0]
        return x + layers.mlp(lp["mlp"], h, cfg.mlp_gated), aux

    # -------------------------------------------------------------- entry points
    def forward_train(
        self,
        params: Params,
        tokens: torch.Tensor,
        labels: torch.Tensor,
        prefix_embeds: Optional[torch.Tensor] = None,
        loss_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """tokens/labels (B, S) (S includes prefix positions for a stub
        frontend) -> (loss, {"ce", "aux", "loss"}), float32 scalars.

        ``prefix_embeds`` (B, P, frontend width) replace the first P
        embedded positions, which then leave the loss (``loss_mask`` times
        the prefix mask), as the reference's ``forward_train`` does. Zamba2's
        shared block is the same tensors at every hybrid position, so its
        gradient sums over them.
        """
        cfg = self.cfg
        x = self._embed_scale(params["embed"][tokens])
        S = x.shape[1]
        if cfg.num_prefix_embeddings and prefix_embeds is not None:
            P = prefix_embeds.shape[1]
            pref = torch.matmul(prefix_embeds.to(x.dtype), params["frontend_proj"])
            x = torch.cat([pref, x[:, P:, :]], dim=1)
            pmask = (torch.arange(S, device=x.device) >= P)[None, :]
            loss_mask = pmask if loss_mask is None else loss_mask * pmask
        rope = None
        if self.has_attention:
            rope = layers.rope_tables(torch.arange(S, device=x.device), cfg.head_dim,
                                      cfg.rope_theta)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(len(self.blocks)):
            lp = self._layer_params(params, i)
            if self.remat == "block":
                x, a = torch.utils.checkpoint.checkpoint(
                    self._train_block, i, lp, x, rope, use_reentrant=False)
            else:
                x, a = self._train_block(i, lp, x, rope)
            aux = aux + a
        logits = self._logits(params, x)
        ce = layers.cross_entropy(logits, labels, loss_mask)
        loss = ce + aux
        return loss, {"ce": ce, "aux": aux, "loss": loss}

    def forward_prefill(
        self,
        params: Params,
        tokens: torch.Tensor,
        cache_len: int,
        caches: Optional[Caches] = None,
        start: Optional[Union[int, torch.Tensor]] = None,
        *,
        prefix_embeds: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Caches]:
        """Prefill. Returns (last-position logits (B, V), caches).

        Fresh sequences: leave ``caches``/``start`` unset. Continuation (a
        chunk, or a piece of the engine's captured prefill): pass the
        caches the earlier tokens left and the absolute position of this
        chunk's first token (not for sliding-window ring caches), as a host
        int or, as the reference's jitted continuation takes a traced int32,
        a 0-dim int64 tensor on the model's device. A tensor ``start`` is
        never read on the host: positions are ``arange(S) + start``, K and V
        go into the cache through a device index and K4 reads the offset on
        the card, so the call can be captured as a CUDA graph. RWKV-6 and
        Mamba2 layers continue from the state in ``caches`` and need no
        position; a piece that starts a prompt at 0 continues from zeroed
        state, which is what a fresh prefill starts from.

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
        if start is None:
            start = 0
        elif not isinstance(start, torch.Tensor):
            start = int(start)
        rope = None
        if self.has_attention:
            rope = layers.rope_tables(torch.arange(S, device=tokens.device) + start,
                                      cfg.head_dim, cfg.rope_theta)
        for i, kind in enumerate(self.blocks):
            lp, c = self._layer_params(params, i), self._layer_cache(caches, i)
            if kind == BlockKind.RWKV6:
                # honours the incoming state: fresh or a continuation alike
                x = rwkv.rwkv_prefill(lp, x, cfg, c, self.plain)
                continue
            if kind == BlockKind.MAMBA2:
                h = layers.rmsnorm(lp["norm"]["scale"], x, cfg.norm_eps)
                y, new = ssm.mamba2_forward(lp["mamba"], h, cfg, None if fresh else c,
                                            plain=self.plain)
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
                x = x + ssm.mamba2_decode(lp["mamba"], h, cfg, c, self.plain)
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


def build_model(cfg: ModelConfig, device=None, plain_kernels: bool = False,
                remat: str = "block") -> Model:
    return Model(cfg, device=device, plain_kernels=plain_kernels, remat=remat)
