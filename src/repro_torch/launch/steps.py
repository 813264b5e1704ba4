"""Step builders for the dry run: meta-device stand-ins for every input,
the step callables, and their sharding specs.

The JAX package's ``repro.launch.steps`` with PyTorch inside. Params,
optimizer state, caches and inputs are tensors on ``torch.device("meta")``
(shapes and dtypes, no allocation and no fill), the pattern a real run then
feeds with tensors on the card. ``build_step`` returns ``(step_fn, args,
in_specs, out_specs)`` as the reference does; ``args`` are meta stand-ins,
and ``step_fn`` runs on whatever tensors it is handed (the meta device for
the dry run's counts, the card or the CPU for a real step).

Layouts. Params and the optimizer moments are in the reference's scan
layout (``models.convert.params_to_scan``: the layers of one unit position
stacked on a leading ``reps`` axis), because that is what the reference's
sharding rules read; ``step_fn`` takes each layer as a view into its stack
(``params_from_scan``), so gradients and AdamW's in-place update land on
the stacks. Caches are in the port's own layout, one tensor per layer
(``cache_specs`` walks it).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import InputShape, ModelConfig, get_shape
from repro_torch.distributed import sharding as shd
from repro_torch.models import Model, build_model
from repro_torch.models.convert import params_from_scan, params_to_scan
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update, lr_schedule
from repro_torch.tree import tree_leaves, tree_map

META = torch.device("meta")


def _meta_twin(model: Model) -> Model:
    return model if model.device == META else build_model(model.cfg, device=META,
                                                          remat=model.remat)


def abstract_params(model: Model) -> Dict[str, Any]:
    """The model's params as meta tensors in the scan layout."""
    meta = _meta_twin(model)
    return params_to_scan(model.cfg, meta._alloc(meta._param_specs(), ()))


def abstract_caches(model: Model, batch: int, seq_len: int) -> Dict[str, Any]:
    """The model's decode caches for ``batch`` sequences of ``seq_len`` as
    meta tensors, one per layer."""
    return _meta_twin(model).init_caches(batch, seq_len)


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    """Meta stand-ins (shape, dtype) for the data-plane inputs of one step."""
    B, S = shape.global_batch, shape.seq_len
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)

    specs: Dict[str, torch.Tensor] = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = meta((B, S), torch.int32)
        if shape.kind == "train":
            specs["labels"] = meta((B, S), torch.int32)
        if cfg.num_prefix_embeddings:
            fed = cfg.frontend_embed_dim or cfg.d_model
            specs["prefix_embeds"] = meta((B, cfg.num_prefix_embeddings, fed), dt)
    else:  # decode
        specs["token"] = meta((B,), torch.int32)
        specs["lengths"] = meta((B,), torch.int32)
    return specs


def loss_and_grads(model: Model, params: Dict[str, Any], tokens: torch.Tensor,
                   labels: torch.Tensor, prefix_embeds: Optional[torch.Tensor] = None,
                   microbatch: int = 1) -> Tuple[torch.Tensor, list]:
    """The train step's loss and gradients over scan-layout ``params`` (a
    list in ``tree_leaves`` order; zeros where the loss does not reach).
    With ``microbatch`` k > 1 the batch runs as k sequential slices whose
    losses and gradients are summed from zero and divided by k, as the
    reference's ``lax.scan`` accumulates them."""
    cfg = model.cfg
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def slice_grads(tok, lab, pref):
        loss, _ = model.forward_train(params_from_scan(cfg, params), tok, lab, pref)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    try:
        if microbatch == 1:
            return slice_grads(tokens, labels, prefix_embeds)
        k = microbatch
        mb = tokens.shape[0] // k
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        grads = [torch.zeros_like(p, requires_grad=False) for p in leaves]
        for i in range(k):
            rows = slice(i * mb, (i + 1) * mb)
            l, g = slice_grads(tokens[rows], labels[rows],
                               None if prefix_embeds is None else prefix_embeds[rows])
            loss = loss + l
            grads = [a + b for a, b in zip(grads, g)]
            del g
        return loss / k, [g / k for g in grads]
    finally:
        for p in leaves:
            p.requires_grad_(False)


def build_step(
    cfg: ModelConfig,
    shape_name: str,
    mesh,
    *,
    remat: str = "block",
    policy: str = "fsdp",
    tenants: int = 1,
    microbatch: int = 1,
    device=None,
) -> Tuple[Callable, Tuple, Any, Any]:
    """Returns (step_fn, abstract_args, in_specs, out_specs).

    policy: weight-sharding policy (see distributed.sharding.param_specs).
    tenants: R > 1 builds the space-time multi-tenant serve step: R tenants'
        weights stacked on a leading axis, the global batch split across
        tenants, one merged step (``Model.forward_decode_tenants``; decode
        shapes only).
    microbatch: k > 1 splits the train batch into k sequential
        gradient-accumulation slices (``loss_and_grads``).
    device: where ``step_fn``'s model runs (the card unless the caller asks
        for the CPU or the meta device); the args are meta stand-ins
        whatever it is.
    """
    shape = get_shape(shape_name)
    model = build_model(cfg, device=device, remat=remat)
    B, S = shape.global_batch, shape.seq_len
    if tenants > 1:
        return _build_multitenant_serve(cfg, model, shape, mesh, tenants)

    p_abs = abstract_params(model)
    p_spec = shd.param_specs(p_abs, mesh, policy)
    in_data = input_specs(cfg, shape)
    d_spec = shd.input_specs_shardings(mesh, B, shape.kind)

    if shape.kind == "train":
        opt_abs = adamw_init(p_abs)
        opt_spec = shd.opt_state_specs(p_abs, mesh, policy)
        opt_spec = AdamWState(step=(), mu=opt_spec, nu=opt_spec)

        if B % microbatch != 0:
            raise ValueError(f"global batch {B} not divisible by microbatch {microbatch}")

        def train_step(params, opt, tokens, labels, prefix_embeds=None):
            loss, grads = loss_and_grads(model, params, tokens, labels, prefix_embeds,
                                         microbatch)
            lr = lr_schedule(opt.step, 3e-4, 100, 1000)
            params, opt, _ = adamw_update(grads, opt, params, lr)
            return params, opt, loss

        args = [p_abs, opt_abs, in_data["tokens"], in_data["labels"]]
        in_specs = [p_spec, opt_spec, d_spec["tokens"], d_spec["labels"]]
        if "prefix_embeds" in in_data:
            args.append(in_data["prefix_embeds"])
            in_specs.append(d_spec["prefix_embeds"])
        out_specs = (p_spec, opt_spec, ())
        return train_step, tuple(args), tuple(in_specs), out_specs

    if shape.kind == "prefill":
        def prefill_step(params, tokens, prefix_embeds=None):
            return model.forward_prefill(params_from_scan(cfg, params), tokens, cache_len=S,
                                         prefix_embeds=prefix_embeds)

        args = [p_abs, in_data["tokens"]]
        in_specs = [p_spec, d_spec["tokens"]]
        if "prefix_embeds" in in_data:
            args.append(in_data["prefix_embeds"])
            in_specs.append(d_spec["prefix_embeds"])
        c_spec = shd.cache_specs(abstract_caches(model, B, S), mesh, B)
        out_specs = ((d_spec["token"][0] if B > 1 else None, None), c_spec)
        return prefill_step, tuple(args), tuple(in_specs), out_specs

    # decode
    cache_abs = abstract_caches(model, B, S)
    c_spec = shd.cache_specs(cache_abs, mesh, B)

    def serve_step(params, token, caches, lengths):
        return model.forward_decode(params_from_scan(cfg, params), token, caches, lengths)

    args = (p_abs, in_data["token"], cache_abs, in_data["lengths"])
    in_specs = (p_spec, d_spec["token"], c_spec, d_spec["lengths"])
    out_specs = ((d_spec["token"][0], None), c_spec)
    return serve_step, args, in_specs, out_specs


def _build_multitenant_serve(cfg, model, shape, mesh, R):
    """Tenant-stacked serve step: params, caches and inputs carry a leading
    tenant axis, sharded over ``data`` when R divides it; per-tenant batch
    = global_batch / R. Tenants take "tp" weights."""
    if shape.kind != "decode":
        raise ValueError("multi-tenant step builder supports decode shapes only")
    B_total, S = shape.global_batch, shape.seq_len
    if B_total % R != 0:
        raise ValueError(f"global batch {B_total} not divisible by tenants {R}")
    B = B_total // R

    def stack_r(tree):
        return tree_map(lambda l: torch.empty((R,) + tuple(l.shape), dtype=l.dtype,
                                              device=META), tree)

    # tenant axis takes `data` when divisible; otherwise tenants replicate
    # and `data` stays on the per-tenant batch inside the inner specs.
    tenant_axis = "data" if R % mesh.shape["data"] == 0 else None

    def prepend(spec_tree, axis):
        def fix(s):
            if axis is None:
                return (None, *s)
            inner = [None if (a == axis or (isinstance(a, tuple) and axis in a)) else a
                     for a in s]
            return (axis, *inner)

        return shd.spec_map(fix, spec_tree)

    single = abstract_params(model)
    p_abs = stack_r(single)
    p_spec = prepend(shd.param_specs(single, mesh, "tp"), tenant_axis)
    caches = abstract_caches(model, B, S)
    cache_abs = stack_r(caches)
    c_spec = prepend(shd.cache_specs(caches, mesh, B), tenant_axis)

    token = torch.empty((R, B), dtype=torch.int32, device=META)
    lengths = torch.empty((R, B), dtype=torch.int32, device=META)
    t_spec = (tenant_axis, None if tenant_axis else "data")

    def serve_step(params, token, caches, lengths):
        return model.forward_decode_tenants(params_from_scan(cfg, params, tenant_axis=True),
                                            token, caches, lengths)

    args = (p_abs, token, cache_abs, lengths)
    in_specs = (p_spec, t_spec, c_spec, t_spec)
    out_specs = ((tenant_axis, None if tenant_axis else "data", None), c_spec)
    return serve_step, args, in_specs, out_specs


def eligible(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """Is (arch, shape) runnable? long_500k needs sub-quadratic attention."""
    shape = get_shape(shape_name)
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "skipped: pure full-attention arch (no sub-quadratic variant)"
    return True, ""
