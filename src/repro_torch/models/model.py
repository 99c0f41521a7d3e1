"""Model assembly, dense family, forward only (twin of the JAX package's
``models/model.py``).

``build(cfg)`` returns a ``Model`` (an ``nn.Module``) whose parameters
mirror the reference's tree path for path: ``embed``, ``unembed``,
``final_ln.scale`` and ``blocks.{ln1,attn,ln2,ffn}.*`` with the layer
weights stacked ``(L, ...)``, so a state dict key is the reference's path
joined with ``.``. A Python loop over the L layers takes the place of
``lax.scan``.

  * ``param_specs()`` / ``init(generator, device)`` / ``param_count()``
  * ``forward(batch)``              -> (logits (B,S,V) f32, aux)
  * ``prefill(batch, max_seq)``     -> (last_logits (B,1,V), cache)
  * ``decode_step(cache, batch)``   -> (logits (B,1,V), cache)
  * ``cache_shapes(batch, max_seq)`` / ``init_cache(batch, max_seq)``

Parameters are stored float32, as in the reference. The reference casts
each weight to the compute dtype at every use (``astype``); the port
makes that cast once and keeps the copy (``compute_params``), which gives
the same bits every step. The norm scales stay float32 (``rmsnorm``
reads them in float32).

Not ported yet (each raises ``NotImplementedError``): the moe, hybrid,
ssm, audio and vlm families, the mesh fields (``act_axes``, ``seq_shard``,
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

Params = dict[str, Any]

_WAITING = {
    "moe": "ROADMAP item 14 (models/moe.py)",
    "hybrid": "ROADMAP item 14 (models/ssm.py and K6, the next slice)",
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
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet: "
                f"{_WAITING.get(cfg.family, 'ROADMAP item 14')}"
            )
        self.cfg = cfg
        self._compute: tuple[Params, list[Params]] | None = None
        # Shapes only until init() or load_params() materializes them.
        specs = self.param_specs()
        _register(self, pr.unflatten(
            (path, torch.empty(s.shape, dtype=torch.float32, device="meta"))
            for path, s in pr.flatten(specs)
        ))

    # --- parameters ---------------------------------------------------------
    def param_specs(self) -> Params:
        cfg = self.cfg
        return {"final_ln": ly.rmsnorm_specs(cfg.d_model),
                "unembed": pr.dense(cfg.d_model, cfg.vocab_size),
                "embed": pr.embed(cfg.vocab_size, cfg.d_model),
                "blocks": _stack_specs(ly.block_specs(cfg), cfg.n_layers)}

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

    def compute_params(self) -> tuple[Params, list[Params]]:
        """(top-level params, per-layer params) in the compute dtype, made
        once: weights, biases and tables cast to ``cdtype``, norm scales
        float32. Per-layer trees are views of the stacked weights."""
        if self._compute is None:
            if self.device.type == "meta":
                raise RuntimeError("Model parameters are not initialized: call init() "
                                   "or load_params() first")
            dt = ly.cdtype(self.cfg)
            pairs = []
            for name, t in self.named_parameters():
                path = tuple(name.split("."))
                pairs.append((path, t.detach() if path[-1] == "scale" else t.detach().to(dt)))
            tree = pr.unflatten(pairs)
            layers = [
                pr.unflatten((path, t[i]) for path, t in pr.flatten(tree["blocks"]))
                for i in range(self.cfg.n_layers)
            ]
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
    def _backbone(self, layers: list[Params], x: torch.Tensor, *,
                  chunked: bool, collect: bool):
        """x: (B,S,d) embedded input. Returns (x, aux, per-layer [(k, v)]
        or None)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        kvs = [] if collect else None
        for bp in layers:
            x, kv = ly.block_apply(self.cfg, bp, x, chunked=chunked, return_kv=True)
            if collect:
                kvs.append(kv)
        return x, aux, kvs

    # --- forward -----------------------------------------------------------------
    @torch.no_grad()
    def forward(self, batch: Params, *, chunked_attn: bool | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits (B,S,V) f32, aux loss scalar)."""
        params, layers = self.compute_params()
        x = self._embed_in(params, batch)
        chunked = _auto_chunked(chunked_attn, x.shape[1])
        x, aux, _ = self._backbone(layers, x, chunked=chunked, collect=False)
        return self._unembed(params, x), aux

    def loss(self, batch: Params):
        raise NotImplementedError("Model.loss waits for LM training (ROADMAP item 14)")

    # --- caches -----------------------------------------------------------------
    def cache_shapes(self, batch: int, max_seq: int) -> Params:
        cfg = self.cfg
        dt = ly.cdtype(cfg)
        kv = {k: TensorSpec((cfg.n_layers,) + v, dt)
              for k, v in ly.attn_cache_shape(cfg, batch, max_seq).items()}
        # PER-SLOT positions (continuous batching)
        return {"layers": kv, "pos": TensorSpec((batch,), torch.int32)}

    def init_cache(self, batch: int, max_seq: int) -> Params:
        def zeros(s: TensorSpec) -> torch.Tensor:
            return torch.zeros(s.shape, dtype=s.dtype, device=self.device)

        return pr.unflatten((path, zeros(s)) for path, s in
                            pr.flatten(self.cache_shapes(batch, max_seq)))

    # --- prefill: ONE pass producing last-token logits AND the decode cache ----
    @torch.no_grad()
    def prefill(self, batch: Params, max_seq: int, *,
                chunked_attn: bool | None = None) -> tuple[torch.Tensor, Params]:
        cfg = self.cfg
        params, layers = self.compute_params()
        x = self._embed_in(params, batch)
        b, s, _ = x.shape
        chunked = _auto_chunked(chunked_attn, s)
        x, _, kvs = self._backbone(layers, x, chunked=chunked, collect=True)
        logits = self._unembed(params, x[:, -1:, :])
        cache = self.init_cache(b, max_seq)
        cache["pos"].fill_(s)
        s_cache = cache["layers"]["k"].shape[2]
        for i, (k, v) in enumerate(kvs):
            for name, t in (("k", k), ("v", v)):
                dst = cache["layers"][name][i]
                if s_cache >= s:  # zero-padded to s_cache
                    dst[:, :s].copy_(t)
                else:
                    # sliding ring buffer: last s_cache positions, rolled so
                    # that absolute position p sits in slot p % s_cache
                    shift = s % s_cache  # position s - s_cache sits at slot shift
                    dst.copy_(torch.roll(t[:, s - s_cache:], shift, dims=1))
        return logits, cache

    # --- single-token decode -------------------------------------------------
    @torch.no_grad()
    def decode_step(self, cache: Params, batch: Params) -> tuple[torch.Tensor, Params]:
        """One token per slot. The K/V rows are written into ``cache`` in
        place (see ``layers.attn_decode``); the returned cache holds the
        same K/V tensors and ``pos + 1``."""
        cfg = self.cfg
        if cfg.is_encoder:
            raise ValueError("encoder-only arch has no decode step")
        params, layers = self.compute_params()
        x = self._embed_in(params, batch)
        pos = cache["pos"]
        k_all, v_all = cache["layers"]["k"], cache["layers"]["v"]
        for i, bp in enumerate(layers):
            x, _ = ly.block_decode(cfg, bp, x, {"k": k_all[i], "v": v_all[i]}, pos)
        new_cache = {"layers": {"k": k_all, "v": v_all}, "pos": pos + 1}
        return self._unembed(params, x), new_cache


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
