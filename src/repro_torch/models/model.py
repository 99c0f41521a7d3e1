"""Model assembly for every family of the zoo (twin of the JAX package's
``models/model.py``).

``build(cfg)`` returns a ``Model`` (an ``nn.Module``) whose parameters
mirror the reference's tree path for path, so a state dict key is the
reference's path joined with ``.``: ``unembed``, ``final_ln.scale``,
``embed`` (``frontend_proj`` for the audio modality), and

  * dense, audio, vlm: ``blocks.{ln1,attn,ln2,ffn}.*`` with the layer
    weights stacked ``(L, ...)``; moe: ``blocks.{ln1,attn,ln2,moe}.*``,
    the experts stacked ``(L, E, ...)`` (``models.moe``);
  * hybrid (zamba2): groups of [shared-attention site + ``attn_every``
    Mamba2 blocks] and a remainder group. ``mamba_groups.*`` is stacked
    ``(n_full, attn_every, ...)``, ``mamba_rest.*`` ``(rem, ...)``, and
    ``shared_attn.*`` is one block whose parameters every site shares;
    each site has its own KV cache;
  * ssm (xlstm): super-blocks of [(period-1) mLSTM + 1 sLSTM]:
    ``supers.mlstm.*`` stacked ``(n_super, period - 1, ...)``,
    ``supers.slstm.*`` ``(n_super, ...)`` (``models.xlstm``).

The frontends are the reference's stubs: audio ``frames`` (B, S,
frontend_dim) go through ``frontend_proj``; vlm ``patches`` (B, n_patches,
d_model) go before the text tokens, attended bidirectionally under
``prefix_lm``, and the loss reads the text positions only. An encoder
(hubert) has no decode step.

Python loops over the layers take the place of ``lax.scan``.

  * ``param_specs()`` / ``param_shapes()`` / ``init(generator, device)``
    / ``param_count()``
  * ``master_params()`` / ``load_params(state)``: the float32 masters
    out (a copy, nested in the reference's paths) and back in
  * ``forward(batch)``              -> (logits (B,S,V) f32, aux)  (serving)
  * ``apply(params, batch)``        -> (logits (B,S,V) f32, aux)  (train)
  * ``loss(params, batch)``         -> (scalar, {"ce", "aux"})
  * ``prefill(batch, max_seq)``     -> (last_logits (B,1,V), cache)
  * ``decode_step(cache, batch)``   -> (logits (B,1,V), cache)
  * ``cache_shapes(batch, max_seq)`` / ``init_cache(batch, max_seq)``

Parameters are stored float32, as in the reference. The reference casts
each weight to the compute dtype at every use (``astype``). Serving makes
that cast once and keeps the detached copy (``compute_params``), which
gives the same bits every step. Training (``apply`` and ``loss``) takes
an explicit tree of float32 masters, the reference's functional form, and
casts it inside autograd on every call, so gradients reach the masters in
float32. The leaves the reference reads in float32 stay float32 in both:
the norm scales (and xLSTM's ``out_norm``), and Mamba2's ``dt_bias`` and
``A_log``. With ``cfg.remat`` each dense or moe block, each full hybrid
group and each xLSTM super-block is a non-reentrant
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
scan body).

Under grad the kernels' gates are shut (``layers._use_flash_kernel``,
``ssm._use_ssd_kernel``): K5 and K6 have no backward, nor have the
reference's Pallas kernels, so training takes the plain paths.

Not ported yet (``build`` raises ``NotImplementedError``): the mesh
fields (``act_axes``, ``seq_shard``, ``context_parallel``, ``moe_wg``)
(ROADMAP.md queue 1, "Mesh and dry-run tools").
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as ly
from repro_torch.models import moe as moe_mod
from repro_torch.models import params as pr
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xl

Params = dict[str, Any]

# Leaves the reference reads in float32 (from its float32 masters).
_FLOAT32_LEAVES = ("scale", "dt_bias", "A_log", "out_norm")

# Families whose layers are one stack of attention blocks.
_BLOCK_FAMILIES = ("dense", "moe", "audio", "vlm")


class TensorSpec(NamedTuple):
    """Shape and dtype of one cache, parameter or optimizer leaf (the
    reference's ShapeDtypeStruct)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def _stack_specs(specs: Params, n: int) -> Params:
    """Give every ParamSpec a leading stack axis of n."""
    return pr.unflatten(
        (path, pr.ParamSpec((n,) + s.shape, s.init, s.scale))
        for path, s in pr.flatten(specs)
    )


def _unstack(tree: Params) -> list[Params]:
    """The trees of views along the leading stack axis (``unbind``: under
    grad its backward stacks the gradients once, where a select per layer
    would each write a zero-filled gradient of the whole stack)."""
    flat = [(path, t.unbind(0)) for path, t in pr.flatten(tree)]
    return [pr.unflatten((path, ts[i]) for path, ts in flat) for i in range(len(flat[0][1]))]


def _maybe_remat(fn, cfg: ArchConfig):
    """``fn`` recomputed in the backward (non-reentrant checkpoint) when
    ``cfg.remat`` and grad mode is on; else ``fn``."""
    if not cfg.remat:
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)

    return run


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
                     "unembed": pr.dense(cfg.d_model, cfg.vocab_size)}
        if cfg.modality == "audio":
            p["frontend_proj"] = pr.dense(cfg.frontend_dim, cfg.d_model)
        else:
            p["embed"] = pr.embed(cfg.vocab_size, cfg.d_model)

        if cfg.family in _BLOCK_FAMILIES:
            block = ly.block_specs(cfg)
            if cfg.family == "moe":
                del block["ffn"]
                block["moe"] = moe_mod.moe_specs(cfg)
            p["blocks"] = _stack_specs(block, cfg.n_layers)
        elif cfg.family == "hybrid":
            n_full, rem, per = self._hybrid_shape()
            mamba = ssm_mod.mamba2_specs(cfg)
            p["mamba_groups"] = _stack_specs(_stack_specs(mamba, per), n_full)
            if rem:
                p["mamba_rest"] = _stack_specs(mamba, rem)
            p["shared_attn"] = ly.block_specs(cfg)
        elif cfg.family == "ssm":  # xlstm
            n_super, per = self._xlstm_shape()
            p["supers"] = _stack_specs(
                {"mlstm": _stack_specs(xl.mlstm_specs(cfg), per - 1),
                 "slstm": xl.slstm_specs(cfg)},
                n_super)
        else:
            raise ValueError(cfg.family)
        return p

    # --- topology helpers ----------------------------------------------------
    def _hybrid_shape(self) -> tuple[int, int, int]:
        """(full groups, Mamba2 blocks in the remainder group, blocks per
        full group)."""
        per = self.cfg.attn_every
        n_full = self.cfg.n_layers // per
        rem = self.cfg.n_layers - n_full * per
        return n_full, rem, per

    def _xlstm_shape(self) -> tuple[int, int]:
        """(super-blocks, blocks per super-block: period - 1 mLSTM and one
        sLSTM)."""
        per = self.cfg.slstm_period
        if self.cfg.n_layers % per:
            raise ValueError(f"{self.cfg.name}: n_layers {self.cfg.n_layers} is not a "
                             f"multiple of slstm_period {per}")
        return self.cfg.n_layers // per, per

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

    def param_shapes(self) -> Params:
        """TensorSpec tree of the float32 masters (the reference's
        ``shape_tree``)."""
        return pr.unflatten((path, TensorSpec(s.shape, torch.float32))
                            for path, s in pr.flatten(self.param_specs()))

    def master_params(self) -> Params:
        """A copy of the float32 masters, nested in the reference's paths:
        the tree ``apply``, ``loss`` and the trainer take. Training it
        leaves the module as it is; ``load_params`` takes it back."""
        self._require_params()
        return pr.unflatten((tuple(name.split(".")), t.detach().clone())
                            for name, t in self.named_parameters())

    def load_params(self, state: dict[str, Any],
                    device: torch.device | str | None = None) -> Model:
        """Take a state dict keyed by the reference's dotted paths (see
        ``convert.lm_params_from_jax``), or a tree nested in those paths
        (``master_params``, a ``TrainState``'s params), as float32 copies
        on ``device`` (the card by default)."""
        dev = resolve_device(device)
        if any(isinstance(v, dict) for v in state.values()):
            state = {".".join(path): t for path, t in pr.flatten(state)}
        want = {".".join(path): s.shape for path, s in pr.flatten(self.param_specs())}
        if set(state) != set(want):
            raise KeyError(f"parameter paths differ: missing {sorted(set(want) - set(state))}, "
                           f"unexpected {sorted(set(state) - set(want))}")
        for key, value in state.items():
            if tuple(value.shape) != want[key]:
                raise ValueError(f"{key}: shape {tuple(value.shape)}, expected {want[key]}")
        self._set_params(pr.unflatten(
            (tuple(key.split(".")),
             value.detach().to(device=dev, dtype=torch.float32, copy=True))
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
        return self.unembed.device

    def compute_params(self) -> tuple[Params, Any]:
        """(top-level params, per-layer params) in the compute dtype, made
        once: weights, biases and tables cast to ``cdtype``; norm scales,
        xLSTM's ``out_norm``, ``dt_bias`` and ``A_log`` float32. Per-layer
        trees are views of the stacked weights: for the dense, moe, audio
        and vlm families a list of the L blocks; for the hybrid family one
        list per attention site of the Mamba2 blocks that follow it (n_full
        lists of attn_every, then the remainder's rem; the shared attention
        block is ``params["shared_attn"]``); for the ssm family one
        (mLSTM blocks, sLSTM block) pair per super-block."""
        if self._compute is None:
            self._require_params()
            self._compute = self._to_compute(
                (tuple(name.split(".")), t.detach()) for name, t in self.named_parameters())
        return self._compute

    def _require_params(self) -> None:
        if self.device.type == "meta":
            raise RuntimeError("Model parameters are not initialized: call init() "
                               "or load_params() first")

    def _to_compute(self, pairs) -> tuple[Params, Any]:
        """(top-level params, per-layer params) from (path, float32 master)
        pairs: each leaf cast to ``cdtype`` (the float32 leaves kept), then
        the stacks unbound into the per-layer trees ``compute_params``
        describes. Under grad the casts and views are part of the graph."""
        dt = ly.cdtype(self.cfg)
        tree = pr.unflatten((path, t if path[-1] in _FLOAT32_LEAVES else t.to(dt))
                            for path, t in pairs)
        if self.cfg.family in _BLOCK_FAMILIES:
            layers = _unstack(tree["blocks"])
        elif self.cfg.family == "ssm":
            layers = [(_unstack(sp["mlstm"]), sp["slstm"]) for sp in _unstack(tree["supers"])]
        else:
            layers = [_unstack(g) for g in _unstack(tree["mamba_groups"])]
            if "mamba_rest" in tree:
                layers.append(_unstack(tree["mamba_rest"]))
        return tree, layers

    # --- embedding -----------------------------------------------------------
    def _embed_in(self, params: Params, batch: Params) -> torch.Tensor:
        cfg = self.cfg
        dt = ly.cdtype(cfg)
        if cfg.modality == "audio":
            return batch["frames"].to(dt) @ params["frontend_proj"].to(dt)
        tok = params["embed"].to(dt)[batch["tokens"].long()]
        if cfg.modality == "vlm":
            return torch.cat([batch["patches"].to(dt), tok], dim=1)
        return tok

    def _unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = ly.rmsnorm(params["final_ln"], x)
        return (x @ params["unembed"].to(x.dtype)).to(torch.float32)

    # --- backbone: one code path for forward AND prefill ----------------------
    def _backbone(self, params: Params, layers, x: torch.Tensor, *,
                  chunked: bool, collect: bool):
        """x: (B,S,d) embedded input. Returns (x, aux, raw cache or None):
        dense, moe, audio, vlm, the per-layer [(k, v)]; hybrid, per
        attention site ((k, v), [the Mamba2 caches of the blocks that
        follow it]); ssm, per super-block ([the mLSTM caches], the sLSTM
        cache). aux is the moe family's load-balance loss averaged over the
        layers, else 0. Under grad with ``cfg.remat`` each dense or moe
        block, each full hybrid group and each super-block is recomputed
        in the backward (the hybrid remainder group is not, as in the
        reference)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        prefix = cfg.n_patches if cfg.prefix_lm else 0
        if cfg.family in ("dense", "audio", "vlm"):
            def block(h, bp):
                out = ly.block_apply(cfg, bp, h, prefix_len=prefix, chunked=chunked,
                                     return_kv=collect)
                return out if collect else (out, None)

            kvs = []
            step = _maybe_remat(block, cfg)
            for bp in layers:
                x, kv = step(x, bp)
                kvs.append(kv)
            return x, aux, (kvs if collect else None)

        if cfg.family == "moe":
            def moe_block(h, bp):
                return moe_mod.moe_block_apply(cfg, bp, h, chunked=chunked, return_kv=collect)

            kvs = []
            step = _maybe_remat(moe_block, cfg)
            for bp in layers:
                x, aux1, kv = step(x, bp)
                aux = aux + aux1
                kvs.append(kv)
            return x, aux / cfg.n_layers, (kvs if collect else None)

        if cfg.family == "ssm":
            def super_block(h, mlstms, slstm):
                mcs = []
                for mp in mlstms:
                    out = xl.mlstm_apply(cfg, mp, h, return_cache=collect)
                    h, mc = out if collect else (out, None)
                    mcs.append(mc)
                out = xl.slstm_apply(cfg, slstm, h, return_cache=collect)
                h, sc = out if collect else (out, None)
                return h, (mcs, sc)

            raw = []
            step = _maybe_remat(super_block, cfg)
            for mlstms, slstm in layers:
                x, sup = step(x, mlstms, slstm)
                raw.append(sup)
            return x, aux, (raw if collect else None)

        def group(h, mamba):
            out = ly.block_apply(cfg, params["shared_attn"], h, chunked=chunked,
                                 return_kv=collect)
            h, kv = out if collect else (out, None)
            mcs = []
            for mp in mamba:
                out = ssm_mod.mamba2_apply(cfg, mp, h, return_cache=collect)
                h, mc = out if collect else (out, None)
                mcs.append(mc)
            return h, (kv, mcs)

        n_full = self._hybrid_shape()[0]
        full_group = _maybe_remat(group, cfg)
        raw = []
        for j, mamba in enumerate(layers):
            x, site = (full_group if j < n_full else group)(x, mamba)
            raw.append(site)
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

    # --- training: an explicit float32 master tree, cast inside autograd ------
    def apply(self, params: Params, batch: Params, *, chunked_attn: bool | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``forward(params, batch)``: (logits (B,S,V) f32,
        aux loss scalar) from the float32 masters ``params`` (nested in the
        reference's paths); gradients reach them through the casts."""
        tree, layers = self._to_compute(pr.flatten(params))
        x = self._embed_in(tree, batch)
        chunked = _auto_chunked(chunked_attn, x.shape[1])
        x, aux, _ = self._backbone(tree, layers, x, chunked=chunked, collect=False)
        return self._unembed(tree, x), aux

    def loss(self, params: Params, batch: Params) -> tuple[torch.Tensor, Params]:
        """(total, {"ce", "aux"}): the mean next-token cross-entropy from a
        float32 log-softmax (over ``batch["mask"]``'s positions when given,
        divided by max(sum(mask), 1), as for the audio modality's masked
        frames; over the text positions for the vlm modality) plus
        ``router_aux_weight * aux``."""
        cfg = self.cfg
        logits, aux = self.apply(params, batch)
        if cfg.modality == "vlm":  # loss only over the text positions
            logits = logits[:, cfg.n_patches:, :]
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, batch["targets"].long()[..., None])[..., 0]
        mask = batch.get("mask")
        if mask is not None:
            ce = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
        else:
            ce = torch.mean(nll)
        total = ce + cfg.router_aux_weight * aux
        return total, {"ce": ce, "aux": aux}

    # --- caches -----------------------------------------------------------------
    def cache_shapes(self, batch: int, max_seq: int) -> Params:
        cfg = self.cfg
        dt = ly.cdtype(cfg)
        kv = ly.attn_cache_shape(cfg, batch, max_seq)
        # PER-SLOT positions (continuous batching)
        pos = TensorSpec((batch,), torch.int32)
        if cfg.family in _BLOCK_FAMILIES:
            return {"layers": {k: TensorSpec((cfg.n_layers,) + v, dt) for k, v in kv.items()},
                    "pos": pos}
        if cfg.family == "ssm":
            n_super, per = self._xlstm_shape()
            ms = xl.mlstm_cache_shape(cfg, batch)
            return {"supers": {
                "mlstm": {"conv": TensorSpec((n_super, per - 1) + ms["conv"], dt),
                          "state": TensorSpec((n_super, per - 1) + ms["state"], torch.float32)},
                "slstm": {n: TensorSpec((n_super,) + v, torch.float32)
                          for n, v in xl.slstm_cache_shape(cfg, batch).items()}},
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
        """Hybrid and ssm prompts have at least ``ssm_conv - 1`` tokens (see
        ``models.ssm``, ``models.xlstm``). The vlm batch's patches count in
        the cache's positions."""
        params, layers = self.compute_params()
        x = self._embed_in(params, batch)
        b, s, _ = x.shape
        chunked = _auto_chunked(chunked_attn, s)
        x, _, raw = self._backbone(params, layers, x, chunked=chunked, collect=True)
        logits = self._unembed(params, x[:, -1:, :])
        cache = self.init_cache(b, max_seq)
        cache["pos"].fill_(s)
        if self.cfg.family in _BLOCK_FAMILIES:
            _write_kv(cache["layers"], raw, s)
            return logits, cache
        if self.cfg.family == "ssm":
            ml, sl = cache["supers"]["mlstm"], cache["supers"]["slstm"]
            for j, (mcs, sc) in enumerate(raw):
                for i, mc in enumerate(mcs):
                    for name, t in mc.items():
                        ml[name][j, i].copy_(t)
                for name, t in sc.items():
                    sl[name][j].copy_(t)
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
        """One token per slot. The K/V rows, the Mamba2 and mLSTM conv tails
        and states and the sLSTM states are written into ``cache`` in place
        (see ``layers.attn_decode``); the returned cache holds the same
        tensors and ``pos + 1``. An encoder raises."""
        cfg = self.cfg
        if cfg.is_encoder:
            raise ValueError("encoder-only arch has no decode step")
        params, layers = self.compute_params()
        x = params["embed"].to(ly.cdtype(cfg))[batch["tokens"].long()]
        pos = cache["pos"]
        if cfg.family in _BLOCK_FAMILIES:
            k_all, v_all = cache["layers"]["k"], cache["layers"]["v"]
            for i, bp in enumerate(layers):
                kv = {"k": k_all[i], "v": v_all[i]}
                decode = moe_mod.moe_block_decode if cfg.family == "moe" else ly.block_decode
                x, _ = decode(cfg, bp, x, kv, pos)
            new_cache = {"layers": {"k": k_all, "v": v_all}, "pos": pos + 1}
            return self._unembed(params, x), new_cache

        if cfg.family == "ssm":
            ml, sl = cache["supers"]["mlstm"], cache["supers"]["slstm"]
            for j, (mlstms, slstm) in enumerate(layers):
                for i, mp in enumerate(mlstms):
                    x, mc = xl.mlstm_decode(cfg, mp, x, {n: t[j, i] for n, t in ml.items()})
                    for n, t in mc.items():
                        ml[n][j, i].copy_(t)
                x, sc = xl.slstm_decode(cfg, slstm, x, {n: t[j] for n, t in sl.items()})
                for n, t in sc.items():
                    sl[n][j].copy_(t)
            new_cache = {"supers": cache["supers"], "pos": pos + 1}
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
            'ported yet: ROADMAP.md queue 1, "Mesh and dry-run tools" (sharding/rules.py)'
        )
    return Model(cfg)


def for_shape(cfg: ArchConfig, shape_name: str) -> ArchConfig:
    """long_500k needs sub-quadratic attention: dense/moe/vlm switch to the
    sliding-window VARIANT (not the published config)."""
    if (shape_name == "long_500k" and cfg.attention == "full"
            and cfg.family in ("dense", "moe", "vlm")):
        return dataclasses.replace(cfg, attention="sliding")
    return cfg
