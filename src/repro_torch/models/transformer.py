"""Decoder-only LM assembled from a ModelConfig (attention + MLP blocks).

Params are a plain dict of tensors, the JAX package's pytree with its
``lax.scan`` over stacked layers written out as a list, one dict per layer:

    {"embed": (V, d), "final_norm": {"scale": (d,)}, "lm_head": (d, V),
     "layers": [{"norm1": {"scale"}, "attn": {"wq", "wk", "wv", "wo"},
                 "norm2": {"scale"}, "mlp": {"up", "gate", "down"}}, ...]}

Caches are ``{"k": [...], "v": [...]}``, one ``(B, Hkv, S_alloc, D)``
tensor per layer (``(R, B, Hkv, S_alloc, D)`` for a tenant-stacked
cohort). ``models.convert`` maps both to and from the JAX layout.

Entry points:
    forward_prefill          tokens (B, S) -> (last-position logits, caches)
    forward_decode           token (B,)    -> (logits (B, V), caches)
    forward_decode_tenants   tokens (R, B) over tenant-stacked params and
                             caches -> (logits (R, B, V), caches): the
                             space-time merged decode step; every projection
                             is one batched product across tenants and each
                             layer's attention is one kernel launch.

Caches are updated in place; the returned caches are the ones passed in
(or freshly allocated, for a fresh prefill).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.config import AttentionKind, BlockKind, ModelConfig
from repro_torch.models import attention, layers

Params = Dict[str, Any]
Caches = Dict[str, List[torch.Tensor]]


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

    ``plain_attention=True`` runs attention through the plain PyTorch
    versions on any device: the opt-in used to hold the kernel path
    against the plain path on the card.
    """

    def __init__(self, cfg: ModelConfig, device=None, plain_attention: bool = False):
        unsupported = sorted({k.value for k in cfg.layer_pattern} - {BlockKind.ATTN_MLP.value})
        if unsupported:
            raise NotImplementedError(
                f"{cfg.name}: block kinds {unsupported} are not ported yet "
                "(see ROADMAP.md); only attn_mlp blocks run")
        if cfg.num_prefix_embeddings:
            raise NotImplementedError(
                f"{cfg.name}: modality frontends are not ported yet (see ROADMAP.md)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _torch_dtype(cfg.dtype)
        self.plain = plain_attention
        self.kinds = [cfg.attention_kind_at(i) for i in range(cfg.num_layers)]

    # -------------------------------------------------------------- init
    def _param_specs(self) -> Params:
        """Params tree with (shape, init) leaves; init in {"dense", "embed", "ones"}."""
        cfg = self.cfg
        d = cfg.d_model
        spec: Params = {
            "embed": ((cfg.vocab_size, d), "embed"),
            "final_norm": {"scale": ((d,), "ones")},
        }
        if not cfg.tie_embeddings:
            spec["lm_head"] = ((d, cfg.vocab_size), "dense")
        mlp = {"up": ((d, cfg.d_ff), "dense"), "down": ((cfg.d_ff, d), "dense")}
        if cfg.mlp_gated:
            mlp["gate"] = ((d, cfg.d_ff), "dense")
        attn = {k: (s, "zeros" if k.startswith("b") else "dense")
                for k, s in attention.attn_param_shapes(cfg).items()}
        spec["layers"] = [
            {"norm1": {"scale": ((d,), "ones")}, "attn": dict(attn),
             "norm2": {"scale": ((d,), "ones")}, "mlp": dict(mlp)}
            for _ in range(cfg.num_layers)
        ]
        return spec

    def _alloc(self, spec: Any, lead: Tuple[int, ...]) -> Any:
        if isinstance(spec, dict):
            return {k: self._alloc(v, lead) for k, v in spec.items()}
        if isinstance(spec, list):
            return [self._alloc(v, lead) for v in spec]
        shape, _ = spec
        return torch.empty(lead + shape, dtype=self.dtype, device=self.device)

    def _fill(self, spec: Any, out: Any, index: Tuple, gen: torch.Generator) -> None:
        if isinstance(spec, dict):
            for k in spec:
                self._fill(spec[k], out[k], index, gen)
            return
        if isinstance(spec, list):
            for s, o in zip(spec, out):
                self._fill(s, o, index, gen)
            return
        _, kind = spec
        target = out[index] if index else out
        if kind == "dense":
            layers.dense_init_(target, gen)
        elif kind == "embed":
            layers.embed_init_(target, gen)
        elif kind == "ones":
            target.fill_(1.0)
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
        """Zeroed caches, one (B, Hkv, S_alloc, D) tensor per layer, with a
        leading tenant axis when ``tenants`` is given."""
        cfg = self.cfg
        lead = (batch,) if tenants is None else (tenants, batch)
        dtype = dtype or self.dtype
        out: Caches = {"k": [], "v": []}
        for kind in self.kinds:
            s = attention.cache_alloc_len(cfg, kind, seq_len)
            shape = lead + (cfg.num_kv_heads, s, cfg.head_dim)
            for name in ("k", "v"):
                out[name].append(torch.zeros(shape, dtype=dtype, device=self.device))
        return out

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
    ) -> Tuple[torch.Tensor, Caches]:
        """Prefill. Returns (last-position logits (B, V), caches).

        Fresh sequences: leave ``caches``/``start`` unset. Chunked
        continuation: pass the previous chunk's caches and the absolute
        position of this chunk's first token (not for sliding-window ring
        caches).
        """
        cfg = self.cfg
        B, S = tokens.shape
        x = self._embed_scale(params["embed"][tokens])
        fresh = caches is None
        if fresh:
            caches = self.init_caches(B, cache_len)
        start = 0 if start is None else int(start)
        rope = layers.rope_tables(torch.arange(start, start + S, device=tokens.device),
                                  cfg.head_dim, cfg.rope_theta)
        for i, (lp, kind) in enumerate(zip(params["layers"], self.kinds)):
            h = layers.rmsnorm(lp["norm1"]["scale"], x, cfg.norm_eps)
            ck, cv = caches["k"][i], caches["v"][i]
            if fresh:
                a = attention.attn_prefill(lp["attn"], h, cfg, kind, ck, cv, rope, self.plain)
            else:
                a = attention.attn_prefill_continue(
                    lp["attn"], h, cfg, kind, ck, cv, start, rope, self.plain)
            x = x + a
            h = layers.rmsnorm(lp["norm2"]["scale"], x, cfg.norm_eps)
            x = x + layers.mlp(lp["mlp"], h, cfg.mlp_gated)
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
        lengths (R, B); caches per layer (R, B, Hkv, S_alloc, D). Returns
        (logits (R, B, V), caches).
        """
        cfg = self.cfg
        R = tokens.shape[0]
        tenant = torch.arange(R, device=tokens.device)[:, None]
        x = self._embed_scale(params["embed"][tenant, tokens])  # (R, B, d)
        rope = layers.rope_tables(lengths.reshape(-1, 1), cfg.head_dim, cfg.rope_theta)
        for i, lp in enumerate(params["layers"]):
            h = layers.rmsnorm(lp["norm1"]["scale"][:, None, :], x, cfg.norm_eps)
            x = x + attention.attn_decode(
                lp["attn"], h, cfg, caches["k"][i], caches["v"][i], lengths, rope, self.plain)
            h = layers.rmsnorm(lp["norm2"]["scale"][:, None, :], x, cfg.norm_eps)
            x = x + layers.mlp(lp["mlp"], h, cfg.mlp_gated)
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


def build_model(cfg: ModelConfig, device=None, plain_attention: bool = False) -> Model:
    return Model(cfg, device=device, plain_attention=plain_attention)
