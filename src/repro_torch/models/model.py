"""Model assembly, dense and hybrid families, forward only (twin of the
JAX package's ``models/model.py``).

``build(cfg)`` returns a ``Model`` (an ``nn.Module``) whose parameters
mirror the reference's tree path for path, so a state dict key is the
reference's path joined with ``.``: ``embed``, ``unembed``,
``final_ln.scale``, and

  * dense: ``blocks.{ln1,attn,ln2,ffn}.*`` with the layer weights stacked
    ``(L, ...)``;
  * hybrid (zamba2): groups of [shared-attention site + ``attn_every``
    Mamba2 blocks] and a remainder group. ``mamba_groups.*`` is stacked
    ``(n_full, attn_every, ...)``, ``mamba_rest.*`` ``(rem, ...)``, and
    ``shared_attn.*`` is one block whose parameters every site shares;
    each site has its own KV cache.

Python loops over the layers take the place of ``lax.scan``.

  * ``param_specs()`` / ``init(generator, device)`` / ``param_count()``
  * ``forward(batch)``              -> (logits (B,S,V) f32, aux)
  * ``prefill(batch, max_seq)``     -> (last_logits (B,1,V), cache)
  * ``decode_step(cache, batch)``   -> (logits (B,1,V), cache)
  * ``cache_shapes(batch, max_seq)`` / ``init_cache(batch, max_seq)``

Parameters are stored float32, as in the reference. The reference casts
each weight to the compute dtype at every use (``astype``); the port
makes that cast once and keeps the copy (``compute_params``), which gives
the same bits every step. The leaves the reference reads in float32 stay
float32: the norm scales, and Mamba2's ``dt_bias`` and ``A_log``.

Not ported yet (each raises ``NotImplementedError``): the moe, ssm,
audio and vlm families, the mesh fields (``act_axes``, ``seq_shard``,
``context_parallel``, ``moe_wg``) and ``loss`` (ROADMAP queue 1, item 14).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as ly
from repro_torch.models import params as pr
from repro_torch.models import ssm as ssm_mod

Params = dict[str, Any]

# Leaves the reference reads in float32 (from its float32 masters).
_FLOAT32_LEAVES = ("scale", "dt_bias", "A_log")

_WAITING = {
    "moe": "ROADMAP item 14 (models/moe.py)",
    "ssm": "ROADMAP item 14 (models/xlstm.py)",
    "audio": "ROADMAP item 14 (the audio frontend)",
    "vlm": "ROADMAP item 14 (the vlm prefix-LM frontend)",
}


class TensorSpec(NamedTuple):
    """Shape and dtype of one cache leaf (the reference's ShapeDtypeStruct)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def _stack_specs(specs: Params, n: int) -> Params:
    """Give every ParamSpec a leading stack axis of n."""
    return pr.unflatten(
        (path, pr.ParamSpec((n,) + s.shape, s.init, s.scale))
        for path, s in pr.flatten(specs)
    )


def _unstack(tree: Params, n: int) -> list[Params]:
    """The n trees of views along the leading stack axis."""
    flat = pr.flatten(tree)
    return [pr.unflatten((path, t[i]) for path, t in flat) for i in range(n)]


def _auto_chunked(chunked: bool | None, s: int) -> bool:
    if chunked is None:
        return s > 2048 and s % 1024 == 0
    return chunked


def _register(module: nn.Module, tree: Params) -> None:
    """Register a nested dict of tensors as child modules and parameters."""
    for key, value in tree.items():
        if isinstance(value, dict):
            child = nn.Module()
            _register(child, value)
            module.add_module(key, child)
        else:
            module.register_parameter(key, nn.Parameter(value, requires_grad=False))


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        if cfg.family not in ("dense", "hybrid"):
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet: "
                f"{_WAITING.get(cfg.family, 'ROADMAP item 14')}"
            )
        self.cfg = cfg
        self._compute: tuple[Params, Any] | None = None
        # Shapes only until init() or load_params() materializes them.
        specs = self.param_specs()
        _register(self, pr.unflatten(
            (path, torch.empty(s.shape, dtype=torch.float32, device="meta"))
            for path, s in pr.flatten(specs)
        ))

    # --- parameters ---------------------------------------------------------
    def param_specs(self) -> Params:
        cfg = self.cfg
        p: Params = {"final_ln": ly.rmsnorm_specs(cfg.d_model),
                     "unembed": pr.dense(cfg.d_model, cfg.vocab_size),
                     "embed": pr.embed(cfg.vocab_size, cfg.d_model)}
        if cfg.family == "dense":
            p["blocks"] = _stack_specs(ly.block_specs(cfg), cfg.n_layers)
        else:  # hybrid
            n_full, rem, per = self._hybrid_shape()
            mamba = ssm_mod.mamba2_specs(cfg)
            p["mamba_groups"] = _stack_specs(_stack_specs(mamba, per), n_full)
            if rem:
                p["mamba_rest"] = _stack_specs(mamba, rem)
            p["shared_attn"] = ly.block_specs(cfg)
        return p

    # --- topology helpers ----------------------------------------------------
    def _hybrid_shape(self) -> tuple[int, int, int]:
        """(full groups, Mamba2 blocks in the remainder group, blocks per
        full group)."""
        per = self.cfg.attn_every
        n_full = self.cfg.n_layers // per
        rem = self.cfg.n_layers - n_full * per
        return n_full, rem, per

    @property
    def n_attn_sites(self) -> int:
        n_full, rem, _ = self._hybrid_shape()
        return n_full + (1 if rem else 0)

    def _set_params(self, tree: Params) -> None:
        for path, value in pr.flatten(tree):
            owner = self.get_submodule(".".join(path[:-1]))
            owner.register_parameter(path[-1], nn.Parameter(value, requires_grad=False))
        self._compute = None

    def init(self, generator: torch.Generator,
             device: torch.device | str | None = None) -> Model:
        """Draw every parameter from ``generator`` (the reference's laws,
        see ``models.params``) onto ``device`` (the card by default)."""
        dev = resolve_device(device)
        self._set_params(pr.init_params(self.param_specs(), generator, dev))
        return self

    def load_params(self, state: dict[str, torch.Tensor],
                    device: torch.device | str | None = None) -> Model:
        """Take a state dict keyed by the reference's dotted paths (see
        ``convert.lm_params_from_jax``) as float32 on ``device`` (the card
        by default)."""
        dev = resolve_device(device)
        want = {".".join(path): s.shape for path, s in pr.flatten(self.param_specs())}
        if set(state) != set(want):
            raise KeyError(f"parameter paths differ: missing {sorted(set(want) - set(state))}, "
                           f"unexpected {sorted(set(state) - set(want))}")
        for key, value in state.items():
            if tuple(value.shape) != want[key]:
                raise ValueError(f"{key}: shape {tuple(value.shape)}, expected {want[key]}")
        self._set_params(pr.unflatten(
            (tuple(key.split(".")), value.to(device=dev, dtype=torch.float32))
            for key, value in state.items()
        ))
        return self

    def _apply(self, fn, *args, **kwargs):
        self._compute = None
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._compute = None
        return super().load_state_dict(*args, **kwargs)

    def param_count(self) -> int:
        return pr.param_count(self.param_specs())

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def compute_params(self) -> tuple[Params, Any]:
        """(top-level params, per-layer params) in the compute dtype, made
        once: weights, biases and tables cast to ``cdtype``; norm scales,
        ``dt_bias`` and ``A_log`` float32. Per-layer trees are views of the
        stacked weights: for the dense family a list of the L blocks, for
        the hybrid family one list per attention site of the Mamba2 blocks
        that follow it (n_full lists of attn_every, then the remainder's
        rem; the shared attention block is ``params["shared_attn"]``)."""
        if self._compute is None:
            if self.device.type == "meta":
                raise RuntimeError("Model parameters are not initialized: call init() "
                                   "or load_params() first")
            dt = ly.cdtype(self.cfg)
            pairs = []
            for name, t in self.named_parameters():
                path = tuple(name.split("."))
                keep = path[-1] in _FLOAT32_LEAVES
                pairs.append((path, t.detach() if keep else t.detach().to(dt)))
            tree = pr.unflatten(pairs)
            if self.cfg.family == "dense":
                layers = _unstack(tree["blocks"], self.cfg.n_layers)
            else:
                n_full, rem, per = self._hybrid_shape()
                layers = [_unstack(g, per) for g in _unstack(tree["mamba_groups"], n_full)]
                if rem:
                    layers.append(_unstack(tree["mamba_rest"], rem))
            self._compute = (tree, layers)
        return self._compute

    # --- embedding -----------------------------------------------------------
    def _embed_in(self, params: Params, batch: Params) -> torch.Tensor:
        dt = ly.cdtype(self.cfg)
        return params["embed"].to(dt)[batch["tokens"].long()]

    def _unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = ly.rmsnorm(params["final_ln"], x)
        return (x @ params["unembed"].to(x.dtype)).to(torch.float32)

    # --- backbone: one code path for forward AND prefill ----------------------
    def _backbone(self, params: Params, layers, x: torch.Tensor, *,
                  chunked: bool, collect: bool):
        """x: (B,S,d) embedded input. Returns (x, aux, raw cache or None):
        dense, the per-layer [(k, v)]; hybrid, per attention site ((k, v),
        [the Mamba2 caches of the blocks that follow it])."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "dense":
            kvs = [] if collect else None
            for bp in layers:
                x, kv = ly.block_apply(cfg, bp, x, chunked=chunked, return_kv=True)
                if collect:
                    kvs.append(kv)
            return x, aux, kvs

        raw = []
        for group in layers:
            x, kv = ly.block_apply(cfg, params["shared_attn"], x, chunked=chunked,
                                   return_kv=True)
            mcs = []
            for mp in group:
                x, mc = ssm_mod.mamba2_apply(cfg, mp, x, return_cache=True)
                mcs.append(mc)
            if collect:
                raw.append((kv, mcs))
        return x, aux, (raw if collect else None)

    # --- forward -----------------------------------------------------------------
    @torch.no_grad()
    def forward(self, batch: Params, *, chunked_attn: bool | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits (B,S,V) f32, aux loss scalar)."""
        params, layers = self.compute_params()
        x = self._embed_in(params, batch)
        chunked = _auto_chunked(chunked_attn, x.shape[1])
        x, aux, _ = self._backbone(params, layers, x, chunked=chunked, collect=False)
        return self._unembed(params, x), aux

    def loss(self, batch: Params):
        raise NotImplementedError("Model.loss waits for LM training (ROADMAP item 14)")

    # --- caches -----------------------------------------------------------------
    def cache_shapes(self, batch: int, max_seq: int) -> Params:
        cfg = self.cfg
        dt = ly.cdtype(cfg)
        kv = ly.attn_cache_shape(cfg, batch, max_seq)
        # PER-SLOT positions (continuous batching)
        pos = TensorSpec((batch,), torch.int32)
        if cfg.family == "dense":
            return {"layers": {k: TensorSpec((cfg.n_layers,) + v, dt) for k, v in kv.items()},
                    "pos": pos}
        n_full, rem, per = self._hybrid_shape()
        ms = ssm_mod.mamba2_cache_shape(cfg, batch)

        def mamba(*stack):
            return {"conv": TensorSpec(stack + ms["conv"], dt),
                    "state": TensorSpec(stack + ms["state"], torch.float32)}

        out = {"mamba": mamba(n_full, per),
               "attn": {k: TensorSpec((self.n_attn_sites,) + v, dt) for k, v in kv.items()},
               "pos": pos}
        if rem:
            out["mamba_rest"] = mamba(rem)
        return out

    def _mamba_sites(self, cache: Params) -> list[Params]:
        """A hybrid cache's Mamba2 leaves per attention site, as views
        {"conv": (blocks, B, ...), "state": (blocks, B, ...)}: the n_full
        groups of ``mamba``, then ``mamba_rest``."""
        n_full = self._hybrid_shape()[0]
        sites = [{n: t[g] for n, t in cache["mamba"].items()} for g in range(n_full)]
        if "mamba_rest" in cache:
            sites.append(cache["mamba_rest"])
        return sites

    def init_cache(self, batch: int, max_seq: int) -> Params:
        def zeros(s: TensorSpec) -> torch.Tensor:
            return torch.zeros(s.shape, dtype=s.dtype, device=self.device)

        return pr.unflatten((path, zeros(s)) for path, s in
                            pr.flatten(self.cache_shapes(batch, max_seq)))

    # --- prefill: ONE pass producing last-token logits AND the decode cache ----
    @torch.no_grad()
    def prefill(self, batch: Params, max_seq: int, *,
                chunked_attn: bool | None = None) -> tuple[torch.Tensor, Params]:
        """Hybrid prompts have at least ``ssm_conv - 1`` tokens (see
        ``models.ssm``)."""
        params, layers = self.compute_params()
        x = self._embed_in(params, batch)
        b, s, _ = x.shape
        chunked = _auto_chunked(chunked_attn, s)
        x, _, raw = self._backbone(params, layers, x, chunked=chunked, collect=True)
        logits = self._unembed(params, x[:, -1:, :])
        cache = self.init_cache(b, max_seq)
        cache["pos"].fill_(s)
        if self.cfg.family == "dense":
            _write_kv(cache["layers"], raw, s)
            return logits, cache
        _write_kv(cache["attn"], [kv for kv, _ in raw], s)
        for site, (_, mcs) in zip(self._mamba_sites(cache), raw):
            for i, mc in enumerate(mcs):
                for name, t in mc.items():
                    site[name][i].copy_(t)
        return logits, cache

    # --- single-token decode -------------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache: Params, batch: Params) -> tuple[torch.Tensor, Params]:
        """One token per slot. The K/V rows and the Mamba2 conv tails and
        states are written into ``cache`` in place (see
        ``layers.attn_decode``); the returned cache holds the same tensors
        and ``pos + 1``."""
        cfg = self.cfg
        if cfg.is_encoder:
            raise ValueError("encoder-only arch has no decode step")
        params, layers = self.compute_params()
        x = self._embed_in(params, batch)
        pos = cache["pos"]
        if cfg.family == "dense":
            k_all, v_all = cache["layers"]["k"], cache["layers"]["v"]
            for i, bp in enumerate(layers):
                x, _ = ly.block_decode(cfg, bp, x, {"k": k_all[i], "v": v_all[i]}, pos)
            new_cache = {"layers": {"k": k_all, "v": v_all}, "pos": pos + 1}
            return self._unembed(params, x), new_cache

        k_all, v_all = cache["attn"]["k"], cache["attn"]["v"]
        for j, (group, site) in enumerate(zip(layers, self._mamba_sites(cache))):
            x, _ = ly.block_decode(cfg, params["shared_attn"], x,
                                   {"k": k_all[j], "v": v_all[j]}, pos)
            for i, mp in enumerate(group):
                x, mc = ssm_mod.mamba2_decode(cfg, mp, x, {n: t[i] for n, t in site.items()})
                for n, t in mc.items():
                    site[n][i].copy_(t)
        new_cache = {k: v for k, v in cache.items() if k != "pos"}
        new_cache["pos"] = pos + 1
        return self._unembed(params, x), new_cache


def _write_kv(dst: Params, kvs: list, s: int) -> None:
    """Write each layer's (or site's) full-sequence (k, v) (B, S, K, hd)
    into the stacked cache leaves dst["k"], dst["v"] (L, B, S_cache, K,
    hd): zero-padded to S_cache, or, when S_cache < S (sliding), the last
    S_cache positions rolled so that absolute position p sits in slot p %
    S_cache."""
    s_cache = dst["k"].shape[2]
    for i, (k, v) in enumerate(kvs):
        for name, t in (("k", k), ("v", v)):
            out = dst[name][i]
            if s_cache >= s:
                out[:, :s].copy_(t)
            else:
                shift = s % s_cache  # position s - s_cache sits at slot shift
                out.copy_(torch.roll(t[:, s - s_cache:], shift, dims=1))


def build(cfg: ArchConfig, act_axes: tuple | None = None, mesh: Any = None,
          seq_shard: bool = False, context_parallel: bool = False,
          moe_wg: bool = False) -> Model:
    if act_axes is not None or mesh is not None or seq_shard or context_parallel or moe_wg:
        raise NotImplementedError(
            "mesh sharding (act_axes, seq_shard, context_parallel, moe_wg) is not "
            "ported yet: ROADMAP item 14 (sharding/rules.py)"
        )
    return Model(cfg)


def for_shape(cfg: ArchConfig, shape_name: str) -> ArchConfig:
    """long_500k needs sub-quadratic attention: dense/moe/vlm switch to the
    sliding-window VARIANT (not the published config)."""
    if (shape_name == "long_500k" and cfg.attention == "full"
            and cfg.family in ("dense", "moe", "vlm")):
        return dataclasses.replace(cfg, attention="sliding")
    return cfg
