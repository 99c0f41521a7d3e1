"""Shared by ``tests/test_torch_moe.py`` and ``tests/test_torch_families.py``:
one reduced config built in both packages on the same parameters, with
the reference's forward, prefill, decode step and loss-and-gradient
function each jitted once (on first use), and the comparisons the two
files make. The parameters are drawn by the port's ``Model.init`` (the
reference's laws) and handed to the reference as arrays: its own eager
``init`` compiles every leaf's draw, seconds a model, and the comparison
needs only the same numbers on both sides.

Tolerances (all float32, on the CPU):
  * MODEL_TOL, logits of a whole reduced model (forward, prefill, decode
    steps) and its caches: 1e-4 absolute and relative -- two layers of f32
    matmuls of length <= 512 summed in another order than XLA's, on values
    of O(1) (the dense and hybrid logits agreed within 3.3e-6 and 7.3e-6).
  * GRAD_REL, gradients at each leaf's scale: max|port - jax| <= 1e-4
    max|jax| per leaf, as for the dense and hybrid families. A leaf whose
    gradient is zero in exact arithmetic has no scale of its own: the
    attention key bias ``bk`` (q . bk is the same for every key of a query,
    and a softmax ignores a shift), whose computed gradient is rounding
    noise in both packages. Both are held below ZERO_GRAD_REL of the
    tree's largest gradient instead.
  * LOSS_TOL: 1e-5 relative (a mean of float32 log-softmax values); the
    moe aux loss likewise (a mean of float32 router probabilities).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import build as jbuild
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import build, params as pr
from repro_torch.training import trainer

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_REL = 1e-4
ZERO_GRAD_REL = 1e-5
ZERO_GRAD_LEAVES = ("bk",)
LOSS_TOL = dict(atol=0, rtol=1e-5)


def jflat_shapes(tree) -> dict:
    """A reference tree's leaf shapes keyed by the dotted path."""
    return {".".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def np32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def close(got, want, tol=MODEL_TOL) -> None:
    np.testing.assert_allclose(np32(got), np32(want), **tol)


def close_scaled(got, want, rel: float, what: str = "") -> None:
    got, want = np32(got), np32(want)
    assert got.shape == want.shape, what
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def close_tree(got: dict, want, rel: float) -> None:
    """Port gradient tree against the reference's (nested dicts), leaf by
    leaf; the ZERO_GRAD_LEAVES both below ZERO_GRAD_REL of the largest."""
    want = convert.lm_params_from_jax(want)
    flat = {".".join(path): t for path, t in pr.flatten(got)}
    assert set(flat) == set(want)
    top = max(float(np.abs(np32(t)).max()) for t in want.values())
    for key, t in flat.items():
        if key.split(".")[-1] in ZERO_GRAD_LEAVES:
            for g in (t, want[key]):
                assert float(np.abs(np32(g)).max()) <= ZERO_GRAD_REL * top, key
        else:
            close_scaled(t, want[key], rel, key)


def close_cache(got: dict, want) -> None:
    """A port cache against the reference's: the same paths and shapes,
    positions equal, every other leaf within MODEL_TOL."""
    flat = dict(pr.flatten(got))
    jflat = {tuple(str(k.key) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert set(flat) == set(jflat)
    for path, t in flat.items():
        assert tuple(t.shape) == tuple(jflat[path].shape), path
        if path == ("pos",):
            np.testing.assert_array_equal(t.numpy(), np.asarray(jflat[path]))
        else:
            close(t, jflat[path])


class Pair:
    """A reduced config in both packages on the same parameters."""

    def __init__(self, arch: str, seed: int):
        self.cfg = get_config(arch).reduced()
        self.jcfg = jget_config(arch).reduced()
        self.jmodel = jbuild(self.jcfg)
        self.model = build(self.cfg).init(torch.Generator().manual_seed(seed), device="cpu")
        self.jparams = pr.unflatten((path, jnp.asarray(np32(t))) for path, t in
                                    pr.flatten(self.model.master_params()))
        self._jit: dict = {}

    def jit(self, name: str):
        if name not in self._jit:
            m = self.jmodel
            self._jit[name] = {
                "forward": lambda: jax.jit(m.forward),
                "prefill": lambda: jax.jit(m.prefill, static_argnums=2),
                "decode": lambda: jax.jit(m.decode_step),
                "loss": lambda: jax.jit(jax.value_and_grad(m.loss, has_aux=True)),
            }[name]()
        return self._jit[name]

    def batch(self, rng, b: int, s: int, kind: str = "prefill") -> dict:
        """A numpy batch of ``s`` positions (a vlm batch's patches count
        among them, as in ``data.synthetic``)."""
        cfg = self.cfg
        out: dict = {}
        if cfg.modality == "audio":
            out["frames"] = rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32)
            if kind == "train":
                out["targets"] = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
                out["mask"] = (rng.random((b, s)) < 0.25).astype(np.float32)
            return out
        st = s - cfg.n_patches if cfg.modality == "vlm" else s
        if cfg.modality == "vlm":
            out["patches"] = rng.normal(size=(b, cfg.n_patches, cfg.d_model)).astype(np.float32)
        toks = rng.integers(2, cfg.vocab_size, size=(b, st + 1)).astype(np.int32)
        out["tokens"] = toks[:, :-1].copy()
        if kind == "train":
            out["targets"] = toks[:, 1:].copy()
        return out

    def params(self):
        return convert.train_state_from_jax(self.jparams, 0, self.jparams, self.jparams,
                                            device="cpu").params


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def to_jax(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def check_forward(pair: Pair, batch: dict) -> None:
    logits, aux = pair.model.forward(to_torch(batch))
    jlogits, jaux = pair.jit("forward")(pair.jparams, to_jax(batch))
    close(logits, jlogits)
    np.testing.assert_allclose(float(aux), float(jaux), **LOSS_TOL)


def check_prefill_decode(pair: Pair, batch: dict, max_seq: int, steps: int, rng) -> None:
    """Prefill (last logits and the whole cache), then ``steps`` decode
    steps (logits, and the cache after the last) against the reference."""
    last, cache = pair.model.prefill(to_torch(batch), max_seq)
    jlast, jcache = pair.jit("prefill")(pair.jparams, to_jax(batch), max_seq)
    close(last, jlast)
    close_cache(cache, jcache)
    b = next(iter(batch.values())).shape[0]
    for _ in range(steps):
        tok = rng.integers(2, pair.cfg.vocab_size, size=(b, 1)).astype(np.int32)
        logits, cache = pair.model.decode_step(cache, {"tokens": torch.from_numpy(tok)})
        jlogits, jcache = pair.jit("decode")(pair.jparams, jcache, {"tokens": jnp.asarray(tok)})
        close(logits, jlogits)
    close_cache(cache, jcache)


def check_loss_and_grads(pair: Pair, batch: dict) -> dict:
    """``Model.loss`` and its gradients against ``jax.value_and_grad`` of
    the reference's; returns the port's metrics."""
    (loss, metrics), grads = trainer.value_and_grad(pair.model.loss, has_aux=True)(
        pair.params(), to_torch(batch))
    (jloss, jmetrics), jgrads = pair.jit("loss")(pair.jparams, to_jax(batch))
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), **LOSS_TOL)
    close_tree(grads, jgrads, GRAD_REL)
    return metrics
