"""Distributed ensembles: the twin of ``repro.core.ensemble``
(``DistributedEnsemble``, ``ensemble_grads`` and ``ensemble_vote``).

The paper trains the rotation forest "on each dataset in parallel using
a cluster of computers": ensemble members are embarrassingly parallel
over data shards (map) and combined by vote (reduce). Each shard of the
mesh's ``data`` dimension fits one member on its own rows; members are
stacked on a leading member axis; a prediction is the mean of the
members' class probabilities.

RNG: member m fits with ``forest_trainer.shard_generators(generator,
S)[m]``, one base draw of the caller's generator plus m, in both
``fit`` (on a mesh) and ``fit_local`` (emulated), so the two modes draw
the same members and return the same bits on the same device type. The
reference draws differently in its two modes (``fold_in(rng, member)``
in ``fit``, ``split(rng, n)`` in ``fit_local``), so its two modes give
different members; the port's streams differ from both, and the tests
compare the packages through converted members.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import mapreduce as mr
from repro_torch.core.forest_trainer import shard_generators


class DistributedEnsemble:
    """Bagged ensemble over the mesh's ``axis_name`` dimension.

    fit_fn     : (generator, x_shard, y_shard) -> member params tree
    predict_fn : (member params, x) -> (N, C) class probabilities
    """

    def __init__(
        self,
        fit_fn: Callable[[torch.Generator, torch.Tensor, torch.Tensor], Any],
        predict_fn: Callable[[Any, torch.Tensor], torch.Tensor],
        axis_name: str = "data",
    ):
        self.fit_fn = fit_fn
        self.predict_fn = predict_fn
        self.axis_name = axis_name

    def fit(self, mesh, generator: torch.Generator, x: torch.Tensor, y: torch.Tensor):
        """One member per rank of ``mesh`` on its rows; every rank returns
        all members, stacked in rank order."""
        return self._fit(mr.mesh_shards(mesh, self.axis_name), generator, x, y)

    def fit_local(self, n_members: int, generator: torch.Generator, x: torch.Tensor,
                  y: torch.Tensor):
        """``fit`` emulated in one process over ``n_members`` row shards."""
        return self._fit(mr.local_shards(n_members), generator, x, y)

    def _fit(self, shards: mr.Shards, generator, x, y):
        gens = shard_generators(generator, shards.count)
        members = [
            self.fit_fn(gens[i], x_s, y_s)
            for i, x_s, y_s in zip(shards.held, shards.split(x), shards.split(y))
        ]
        return mr._tree_map(torch.stack, shards.gather(members))

    def predict_proba(self, params: Any, x: torch.Tensor) -> torch.Tensor:
        """``params`` has a leading member axis; the vote is the mean of
        the members' probabilities, summed in member order."""
        probs = [
            self.predict_fn(mr._tree_map(lambda ls, m=m: ls[0][m], [params]), x)
            for m in range(mr._leaves(params)[0].shape[0])
        ]
        return mr.reduce_mean(probs)

    def predict(self, params: Any, x: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.predict_proba(params, x), dim=-1)


def ensemble_grads(loss_fn: Callable, params: Any, batch: Any, ensemble_axis: str | None):
    """Per-member (loss, grads): exactly data-parallel gradients WITHOUT
    the reduction over ``ensemble_axis`` (members see disjoint data shards
    and diverge: that is the bagging). With ``ensemble_axis=None`` this is
    the plain single-model (loss, grads)."""
    from repro_torch.training.trainer import value_and_grad

    return value_and_grad(loss_fn)(params, batch)


def ensemble_vote(logits: torch.Tensor, mesh, axis_name: str = "data") -> torch.Tensor:
    """Vote-reduce this rank's member logits: softmax, then the mean over
    the ranks of ``mesh``'s ``axis_name`` dimension (gathered and folded
    in rank order); every rank gets the same probabilities."""
    probs = torch.softmax(logits, dim=-1)
    return mr.reduce_mean(mr.mesh_shards(mesh, axis_name).gather([probs]))


__all__ = ["DistributedEnsemble", "ensemble_grads", "ensemble_vote"]
