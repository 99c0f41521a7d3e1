"""Training steps (twin of the JAX package's ``training/trainer.py``).

``make_train_step``          -- one step of the model on a batch, with
                                optional float32 gradient accumulation over
                                sequential microbatches.
``make_ensemble_train_step`` -- the paper's MapReduce schedule generalized
                                to gradient models: members train on
                                disjoint shards of the batch and
                                deliberately do NOT sync gradients
                                (bagging); the member axis is a loop over
                                members here (the reference's ``vmap``),
                                stacked on a leading member dimension.

A state is a ``TrainState`` of float32 master parameters (the tree
``Model.apply`` takes) and an ``AdamWState``. A step writes the state's
tensors in place and returns a state holding them (see ``optim.adamw``).
``save_state`` / ``restore_state`` keep a state in the checkpoint store
under the reference's keys (``.params/<path>``, ``.opt/.step``,
``.opt/.m/<path>``, ``.opt/.v/<path>``), so a train checkpoint written by
either package restores in the other.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.checkpoint import store
from repro_torch.core import mapreduce as mr
from repro_torch.core.forest_trainer import shard_generators
from repro_torch.device import resolve_device
from repro_torch.models import params as pr
from repro_torch.models.model import Model
from repro_torch.optim.adamw import AdamWState, Optimizer, apply_updates, opt_shapes

_MESH = 'ROADMAP.md queue 1, "Mesh and dry-run tools"'


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def train_state_shapes(model: Model, optimizer: Optimizer) -> TrainState:
    ps = model.param_shapes()
    return TrainState(ps, opt_shapes(ps))


def value_and_grad(fn: Callable, has_aux: bool = False) -> Callable:
    """``jax.value_and_grad`` for a function of a tree of tensors: returns
    ``(params, *args) -> (fn's output, grads)``, the gradient of fn's
    (first, with ``has_aux``) output with respect to every leaf of
    ``params`` (zeros where a leaf does not reach it), outputs detached."""

    def run(params: Any, *args):
        flat = pr.flatten(params)
        leaves = [t.detach().requires_grad_() for _, t in flat]
        with torch.enable_grad():
            out = fn(pr.unflatten((path, t) for (path, _), t in zip(flat, leaves)), *args)
            grads = torch.autograd.grad(out[0] if has_aux else out, leaves,
                                        allow_unused=True, materialize_grads=True)
        if has_aux:
            out = (out[0].detach(), {k: v.detach() for k, v in out[1].items()})
        else:
            out = out.detach()
        return out, pr.unflatten((path, g) for (path, _), g in zip(flat, grads))

    return run


def microbatch(batch: dict, k: int, i: int) -> dict:
    """Microbatch i of k: rows [i n / k, (i + 1) n / k) of every leaf (the
    reference's reshape to (k, n / k, ...))."""
    return {name: t.reshape((k, t.shape[0] // k) + tuple(t.shape[1:]))[i]
            for name, t in batch.items()}


def make_train_step(model: Model, optimizer: Optimizer, microbatches: int | None = None):
    """(state, batch) -> (state, metrics).

    ``microbatches=k`` splits the global batch into k sequential
    micro-steps with float32 gradient accumulation (activation memory / k);
    the gradients, the loss and the metrics are the means over them."""
    grads_of = value_and_grad(model.loss, has_aux=True)

    def train_step(state: TrainState, batch: dict):
        if microbatches and microbatches > 1:
            k = microbatches
            gsum, losses, ms = None, [], []
            for i in range(k):
                (loss, metrics), g = grads_of(state.params, microbatch(batch, k, i))
                if gsum is None:
                    gsum = {path: t.to(torch.float32) for path, t in pr.flatten(g)}
                else:
                    for path, t in pr.flatten(g):
                        gsum[path].add_(t.to(torch.float32))
                losses.append(loss)
                ms.append(metrics)
            grads = pr.unflatten((path, t / k) for path, t in gsum.items())
            loss = sum(losses) / k
            metrics = {name: torch.stack([m[name] for m in ms]).mean(0) for name in ms[0]}
        else:
            (loss, metrics), grads = grads_of(state.params, batch)
        updates, opt = optimizer.update(grads, state.opt, state.params)
        params = apply_updates(state.params, updates)
        metrics = dict(metrics, loss=loss)
        return TrainState(params, opt), metrics

    return train_step


def _one_rank(mesh) -> None:
    if mesh is not None and mesh.size() != 1:
        raise NotImplementedError(
            f"an ensemble over a mesh of {mesh.size()} ranks waits for sharding ({_MESH}); "
            "pass mesh=None or a one-rank mesh")


def member(tree: Any, m: int) -> Any:
    """Member m's views of a stacked tree or state (writes go to the stack)."""
    return mr._tree_map(lambda leaves: leaves[0][m], [tree])


def clone_tree(tree: Any) -> Any:
    """A copy of every leaf of a tree or state (to step a copy of a state,
    leaving the original as it is)."""
    return mr._tree_map(lambda leaves: leaves[0].clone(), [tree])


def make_ensemble_train_step(model: Model, optimizer: Optimizer, mesh, n_members: int):
    """Paper technique (T1): each of ``n_members`` members trains on its
    own shard of the global batch with NO gradient sync across members.
    The reference never reads ``mesh`` in the step; here it must be None or
    a mesh of one rank.

    Returns (ensemble_state, batch) -> (ensemble_state, metrics); member
    params and optimizer state have a leading dim ``n_members``, metrics
    are stacked likewise."""
    _one_rank(mesh)
    step = make_train_step(model, optimizer)

    def ensemble_step(states: TrainState, batch: dict):
        # batch leading axis: (n_members * per_member, ...) -> member-major
        metrics = [step(member(states, m), microbatch(batch, n_members, m))[1]
                   for m in range(n_members)]
        return states, {name: torch.stack([mm[name] for mm in metrics]) for name in metrics[0]}

    return ensemble_step


def ensemble_init(model: Model, optimizer: Optimizer, generator: torch.Generator,
                  n_members: int, device: torch.device | str | None = None) -> TrainState:
    """Member m's parameters drawn from a generator of its own
    (``forest_trainer.shard_generators(generator, n_members)[m]``),
    stacked, with a fresh optimizer state each, on ``device`` (the card by
    default)."""
    dev = resolve_device(device)
    specs = model.param_specs()
    members = [pr.init_params(specs, g, dev) for g in shard_generators(generator, n_members)]
    return mr._tree_map(torch.stack, [TrainState(p, optimizer.init(p)) for p in members])


def ensemble_member_pspecs(param_pspecs_tree: Any) -> Any:
    raise NotImplementedError(f"member partition specs wait for sharding ({_MESH})")


# --- the train checkpoint -----------------------------------------------------

def _keyed(state: TrainState) -> dict:
    return {".params": state.params,
            ".opt": {".step": state.opt.step, ".m": state.opt.m, ".v": state.opt.v}}


def save_state(directory: str, step: int, state: TrainState) -> str:
    """Write ``state`` as checkpoint step ``step`` under the reference's keys."""
    return store.save(directory, step, _keyed(state))


def restore_state(directory: str, step: int, like: TrainState | None = None,
                  device: torch.device | str | None = None) -> TrainState:
    """The ``TrainState`` of checkpoint step ``step`` on ``device`` (the
    card by default). With ``like`` (``train_state_shapes``, or a state),
    every leaf's key, shape and dtype is checked against the manifest
    before any array is read."""
    dev = resolve_device(device)
    if like is not None:
        want = {key: (tuple(t.shape), t.dtype) for key, t in store._flatten(_keyed(like)).items()}
        got = {key: (s.shape, s.dtype) for key, s in store.manifest_like(directory, step).items()}
        if got != want:
            bad = sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k))
            raise ValueError(f"train checkpoint step {step} in {directory!r} does not match "
                             f"the expected state at {bad[:5]} ({len(bad)} leaves)")
    flat = {key: t.to(dev) for key, t in store.restore(directory, step).items()}

    def tree(prefix: str) -> dict:
        return pr.unflatten((tuple(key[len(prefix):].split("/")), t)
                            for key, t in flat.items() if key.startswith(prefix))

    return TrainState(tree(".params/"),
                      AdamWState(flat[".opt/.step"], tree(".opt/.m/"), tree(".opt/.v/")))
