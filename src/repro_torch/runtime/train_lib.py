"""Training step builder: microbatching + remat + AdamW on one card (port of
``repro.runtime.train_lib``).

``build_train_step`` returns a step with optional gradient accumulation over
microbatches and optional int8 error-feedback gradient compression.  The
reference jits the step and shards it over a mesh; the port runs it eagerly,
on one device or, given a ``DeviceMesh``, over DTensor state placed by
``state_shardings`` (``runtime.sharding_rules``) with the mesh and the
model's ``RunOpts.mesh_rules()`` installed around the step
(``runtime.mesh_ctx.use_mesh``), and updates the state in place, as the
reference's donated state lets XLA do.

``plan_remat_policy`` is the paper's training loop: profile the grad step
(``make_fx`` on fake tensors, so nothing is allocated at full width), pack
it by best fit, search evictions, compile the policy, re-trace under it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from ..models.transformer import Transformer
from ..optim import adamw, grad_compress
from . import mesh_ctx, sharding_rules


@dataclass(frozen=True)
class TrainOpts:
    microbatches: int = 1
    # bool (legacy: True = full remat) or a repro_torch.remat.RematPolicy.
    remat: Any = True
    compress_grads: bool = False

    def __post_init__(self):
        self.remat_policy       # fail fast on values coerce() rejects

    @property
    def remat_policy(self):
        from ..remat.policy import RematPolicy
        return RematPolicy.coerce(self.remat)


def init_state(model: Transformer, generator: torch.Generator,
               adamw_cfg: adamw.AdamWConfig, opts: TrainOpts = TrainOpts()):
    """f32 master parameters drawn from ``generator``, zero moments, step 0."""
    params = model.init(generator)
    state = {"params": params, "opt": adamw.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    if opts.compress_grads:
        state["err"] = grad_compress.init_error(params)
    return state


def state_shardings(model: Transformer, mesh, opts: TrainOpts = TrainOpts()):
    """PartitionSpecs of the train state: parameters, moments and the error
    residuals by ``sharding_rules.param_specs``, counters replicated."""
    pspecs = sharding_rules.param_specs(model.schema(), mesh)
    repl = sharding_rules.replicated(mesh)
    state = {"params": pspecs,
             "opt": {"m": pspecs, "v": pspecs, "count": repl},
             "step": repl}
    if opts.compress_grads:
        state["err"] = pspecs
    return state


def abstract_state(model: Transformer, mode: FakeTensorMode,
                   adamw_cfg: adamw.AdamWConfig, opts: TrainOpts = TrainOpts()):
    """The train state as fake tensors of ``mode``: shapes and dtypes on the
    model's device, no memory (dry runs and profiles)."""
    params = model.abstract(mode)
    with mode:
        state = {"params": params, "opt": adamw.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=model.device)}
        if opts.compress_grads:
            state["err"] = grad_compress.init_error(params)
    return state


def batch_specs(cfg, batch: int, seq: int, frames_dtype: torch.dtype) -> dict:
    """A training batch as ``{name: (shape, dtype)}``: ``(batch, seq + 1)``
    int32 tokens and, for an encoder-decoder, ``(batch, encoder_seq,
    d_model)`` frames in ``frames_dtype`` (the data pipeline's are f32)."""
    specs = {"tokens": ((batch, seq + 1), torch.int32)}
    if cfg.is_encoder_decoder:
        specs["frames"] = ((batch, cfg.encoder_seq, cfg.d_model), frames_dtype)
    return specs


def _fake_batch(mode: FakeTensorMode, batch_sds: dict, device) -> dict:
    """``{name: (shape, dtype)}`` -> fake tensors of ``mode``."""
    with mode:
        return {k: torch.empty(shape, dtype=dt, device=device)
                for k, (shape, dt) in batch_sds.items()}


def leaf_grads(loss, leaves):
    """The gradient of ``loss`` for every leaf, zeros for a leaf the loss
    does not read (the ``norm`` of whisper's cross-attention, which its
    ``xnorm`` replaces), as ``jax.grad`` gives them."""
    return torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)


def grad_step(model: Transformer, remat):
    """``(params, batch) -> grads``: the step the remat planner profiles."""
    def step(params, batch):
        loss, _ = model.loss_fn(params, batch, remat=remat)
        return leaf_grads(loss, tree_leaves(params))
    return step


def profile_step(model: Transformer, batch_sds: dict, remat=False, *,
                 grad: bool = True, loaded: bool = False):
    """``make_fx`` liveness profile of ``grad(loss)`` (of the loss alone
    with ``grad=False``) on fake f32 masters and a fake batch (``{name:
    (shape, dtype)}``): nothing is allocated.  ``loaded=True`` profiles over
    ``model.load``'s cast copies instead, the dtypes a fine-tune of served
    weights runs in (bf16 at the registered configs)."""
    from ..core import profile_fn
    mode = FakeTensorMode()
    params = model.abstract(mode)
    if loaded:
        with mode:
            params = model.load(params)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(grad)
    fn = (grad_step(model, remat) if grad
          else lambda p, b: model.loss_fn(p, b, remat=remat)[0])
    return profile_fn(fn, params, _fake_batch(mode, batch_sds, model.device))


def plan_remat_policy(model: Transformer, batch_sds: dict, *,
                      target_ratio: float = 0.5,
                      target_peak: Optional[int] = None,
                      planner=None, max_rounds: int = 3,
                      max_evict: int = 256,
                      profile=None, shared=None):
    """Profile the no-remat grad step, search evictions, compile the policy.

    Returns ``(RematPolicy, EvictionPlan)`` — the profile-guided replacement
    for ``TrainOpts(remat=True)``.  ``batch_sds`` is ``{name: (shape,
    dtype)}``; profiles are taken over ``grad(loss)`` on fake parameters and
    batch, so nothing is allocated; pass ``profile`` to reuse an
    already-computed no-remat profile.  ``max_evict`` bounds each round's
    search (``MemoryPlanner.plan_with_remat``).

    ``shared`` — a ``core.unified.TenantView`` for the training tenant (the
    ``--share-hbm`` path): the eviction target becomes the tenant's share of
    the joint serve+train budget, and the final post-eviction profile is
    staged back so the SharedArena rebalances the split at its next round
    boundary.

    The compile is closed-loop: an op-level policy can miss the target the
    block-level search hit (residuals of unselected ops survive, and a
    selective checkpoint saves the outputs of every other op), so the step
    is re-traced under the compiled policy and, while the packed peak still
    misses the target, the search re-runs on the *actual* trace and its
    selection is unioned in — up to ``max_rounds`` refinements.  The
    returned plan aggregates every round's evictions, and its
    ``baseline_peak``/``peak`` are the no-remat baseline and the peak of the
    final policy's verified trace — not intermediate search estimates.
    """
    from ..core import MemoryPlanner
    from ..remat import EvictionPlan, RematPolicy
    from ..remat.policy import _prim_of_tag

    planner = planner or MemoryPlanner()

    def prof_with(remat):
        return profile_step(model, batch_sds, remat)

    # Only select blocks a checkpoint policy can actually address, so every
    # accepted eviction compiles and the reported savings are deliverable.
    def expressible(c):
        return _prim_of_tag(c.tag) is not None

    # Delivery is a checkpoint policy, so price everything at recompute cost
    # (offload-mode selections compile into the recompute set too).
    prof = profile if profile is not None else prof_with(False)
    if shared is not None and target_peak is None:
        target_peak = shared.budget     # the tenant's share of the split
    ev0 = planner.plan_with_remat(prof, target_peak=target_peak,
                                  target_ratio=None if target_peak else target_ratio,
                                  max_evict=max_evict, candidate_filter=expressible,
                                  price_mode="recompute")
    target = ev0.target_peak
    policy = RematPolicy.from_eviction(ev0)
    evictions = list(ev0.evictions)
    achieved, final_plan, final_profile = ev0.peak, ev0.plan, ev0.profile
    rounds = 0
    if policy.enabled:
        while True:
            traced = prof_with(policy)
            final_plan = planner.plan(traced)
            achieved, final_profile = final_plan.peak, traced
            if target is None or achieved <= target or rounds >= max_rounds:
                break
            rounds += 1
            ev_i = planner.plan_with_remat(traced, target_peak=target,
                                           max_evict=max_evict,
                                           candidate_filter=expressible,
                                           price_mode="recompute")
            refined = RematPolicy.from_eviction(ev_i)
            merged = RematPolicy(
                mode="policy",
                recompute_prims=policy.recompute_prims | refined.recompute_prims,
                offload_prims=policy.offload_prims | refined.offload_prims)
            if merged == policy:      # fixed point: nothing new to evict
                break
            covered = policy.recompute_prims | policy.offload_prims
            policy = merged
            # aggregate only genuinely new selections: blocks of ops the
            # pre-merge policy already evicted would double-count
            evictions.extend(e for e in ev_i.evictions
                             if _prim_of_tag(e.tag) not in covered)
    ev = EvictionPlan(
        evictions=evictions,
        baseline_peak=ev0.baseline_peak,
        peak=achieved,
        overhead_s=sum(e.cost_s for e in evictions),
        target_peak=target,
        plan=final_plan,
        profile=final_profile,
        meta={"rounds": rounds, "verified": policy.enabled,
              "policy": policy.describe()},
    )
    if shared is not None:
        # stage the verified post-remat step rectangles; the SharedArena
        # rebalances the serve/train split at its next round boundary
        shared.request_replan(final_profile)
        shared.shared.reset_round()
    return policy, ev


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    def split(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible into {n} microbatches")
        return x.reshape(n, b // n, *x.shape[1:])
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def build_train_step(model: Transformer, mesh, adamw_cfg: adamw.AdamWConfig,
                     opts: TrainOpts = TrainOpts()):
    """Returns ``(step, None)`` without a mesh, else ``(step,
    (state_shardings, batch_shardings_fn))`` as the reference does;
    ``step(state, batch) -> (state, metrics)`` updates ``state`` in place.

    With a ``DeviceMesh`` the state must be DTensors placed by those
    shardings (``sharding_rules.distribute_tree``); the batch may be full
    tensors, the same on every rank, or DTensors: each (micro)batch is
    placed by ``batch_shardings_fn`` of its shapes.  Gradients are
    redistributed to their parameter's placements before the update, and
    the metrics come back as full tensors."""
    if mesh is not None:
        mesh_ctx.check_mesh(mesh, "build_train_step")

    def grads_of(params, leaves, mb):
        loss, metrics = model.loss_fn(params, mb, remat=opts.remat)
        grads = leaf_grads(loss, leaves)
        if mesh is not None:
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, leaves)]
        return loss.detach(), metrics, grads

    def place(mb):
        if mesh is None:
            return mb
        specs = sharding_rules.batch_specs(mb, mesh)
        return {k: mesh_ctx.distribute(v, mesh, specs[k]) for k, v in mb.items()}

    def step_fn(state, batch):
        params = state["params"]
        leaves, spec = tree_flatten(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        if opts.microbatches > 1:
            gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            if mesh is not None:
                batch = {k: mesh_ctx.whole(v) for k, v in batch.items()}
            for mb in _split_microbatches(batch, opts.microbatches):
                loss, _, g = grads_of(params, leaves, place(mb))
                gsum = [a + b for a, b in zip(gsum, g)]
                lsum = lsum + loss
            grads = [g / opts.microbatches for g in gsum]
            loss = lsum / opts.microbatches
            metrics = {}
        else:
            loss, metrics, grads = grads_of(params, leaves, place(batch))
        grads = tree_unflatten(list(grads), spec)

        new_state = dict(state)
        if opts.compress_grads:
            grads, new_err = grad_compress.compress_decompress(grads, state["err"])
            new_state["err"] = new_err
        new_params, new_opt, om = adamw.update(grads, state["opt"], params, adamw_cfg)
        new_state.update(params=new_params, opt=new_opt, step=state["step"] + 1)
        out_metrics = {"loss": loss, **{k: v.detach() for k, v in metrics.items()},
                       **om}
        return new_state, out_metrics

    if mesh is None:
        return step_fn, None

    def sharded_step(state, batch):
        with mesh_ctx.use_mesh(mesh, rules=model.opts.mesh_rules()):
            new_state, metrics = step_fn(state, batch)
            return new_state, {k: mesh_ctx.whole(v) for k, v in metrics.items()}

    return sharded_step, (state_shardings(model, mesh, opts),
                          lambda batch_shapes: sharding_rules.batch_specs(batch_shapes, mesh))


def abstract_sharded_step(model: Transformer, mesh, mode: FakeTensorMode,
                          adamw_cfg: adamw.AdamWConfig, opts: TrainOpts, batch_sds: dict):
    """``build_train_step``'s step over ``mesh`` as a function of this
    rank's local shards, for a dry run's ``make_fx``: returns ``(fn,
    shards)`` (``mesh_ctx.on_local_shards``).  The shards are fake tensors
    of ``mode``: each train-state leaf's under ``state_shardings``, each
    batch leaf's (``{name: (shape, dtype)}``) under ``batch_specs``."""
    step, (st_specs, batch_specs_fn) = build_train_step(model, mesh, adamw_cfg, opts)
    state = abstract_state(model, mode, adamw_cfg, opts)
    batch = _fake_batch(mode, batch_sds, model.device)
    return mesh_ctx.on_local_shards(step, (state, batch), (st_specs, batch_specs_fn(batch)),
                                    mesh, mode)
