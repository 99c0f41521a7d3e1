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

The mesh fields (``build(cfg, act_axes=, mesh=, seq_shard=,
context_parallel=, moe_wg=)``): with a ``DeviceMesh`` the parameters are
DTensors placed by ``sharding.rules.param_pspecs`` (``place_params``
picks the strategy; ``init`` and ``load_params`` place them), batches
are placed by ``batch_pspecs`` (a batch given as plain tensors must lie on
the mesh's device type, else it raises), caches by ``cache_pspecs``, and
the activations are DTensors that the reference's constraints re-place:
``_constrain`` (batch over ``act_axes``, after the embedding gather, whose
vocab-sharded table leaves them partial), ``_constrain_seq`` (the sequence
over 'model' between blocks, ``seq_shard``), ``_cp`` (the query chunks
over 'model', ``context_parallel``), ``_buf_constrain`` and
``_wg_constrain`` (the MoE buffers and, with ``moe_wg``, the expert weight
gradients). K5 and K6 run on each rank's local shard
(``layers._attend_on_mesh``, ``ssm._ssm_inner_on_mesh``); their gates are
the same as off the mesh. The xLSTM blocks and the recurrent decode steps
run data-parallel (``ActMesh.data_parallel``: weights gathered, rows
split). Every mesh method runs under DTensor's implicit replication, so
the constants the layers make (positions, masks) act as replicated.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.sharding import activations as act
from repro_torch.sharding import rules
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
    def __init__(self, cfg: ArchConfig, act_axes: tuple | None = None, mesh: Any = None,
                 seq_shard: bool = False, context_parallel: bool = False,
                 moe_wg: bool = False):
        super().__init__()
        self.cfg = cfg
        # The DeviceMesh, the mesh axes carrying the global batch (e.g.
        # ("data",) or ("pod", "data")) and seq_shard, all in ``self._sh``;
        # see the module docstring.
        self._sh = act.ActMesh(mesh, act_axes, seq_shard) if mesh is not None else None
        # Context parallelism: asked for, on a model axis of more than one rank.
        self._cp = bool(context_parallel and self._sh is not None and self._sh.tp > 1)
        self.moe_wg = moe_wg
        self.strategy, self.align_heads = "2d", True
        self._compute: tuple[Params, Any] | None = None
        # Shapes only until init() or load_params() materializes them.
        specs = self.param_specs()
        _register(self, pr.unflatten(
            (path, torch.empty(s.shape, dtype=torch.float32, device="meta"))
            for path, s in pr.flatten(specs)
        ))

    # --- the mesh -------------------------------------------------------------
    def _mesh_ctx(self):
        """Implicit replication on a mesh (the layers' plain constants act
        as replicated DTensors); nothing off it."""
        if self._sh is None:
            return contextlib.nullcontext()
        return act.implicit_replication()

    def _batch_total(self) -> int:
        return math.prod(self._sh.shape[a] for a in self._sh.act_axes)

    def _constrain(self, x: torch.Tensor) -> torch.Tensor:
        """Batch over ``act_axes`` (when they divide it), the rest
        replicated (partial sums reduced)."""
        sh = self._sh
        if sh is None or sh.act_axes is None or x.shape[0] % self._batch_total():
            return x
        return rules.place(x, sh.mesh, (sh.batch(x.shape[0]),) + (None,) * (x.dim() - 1))

    def _constrain_seq(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, d) -> S sharded over 'model' (sequence parallelism)."""
        sh = self._sh
        if sh is None or not sh.seq_shard or sh.act_axes is None or x.dim() != 3:
            return x
        if x.shape[0] % self._batch_total() or x.shape[1] % sh.tp:
            return x
        return rules.place(x, sh.mesh, (sh.batch(x.shape[0]), "model", None))

    def _buf_constrain(self):
        sh = self._sh
        if sh is None or sh.act_axes is None:
            return None

        def fn(t):
            # t: (B, E, C, d) dispatch/result buffers
            return rules.place(t, sh.mesh, (sh.batch(t.shape[0]), sh.heads(t.shape[1]), None, None))

        return fn

    def _wg_constrain(self):
        if not self.moe_wg or self._sh is None:
            return None

        def fn(g):
            # g: (E, r, c) weight grad; E -> model, r -> data (the expert
            # parameter/optimizer layout), guarded by divisibility.
            data = self._sh.shape.get("data", 1)
            r_ax = "data" if data > 1 and g.shape[1] % data == 0 else None
            return rules.place(g, self._sh.mesh, (self._sh.heads(g.shape[0]), r_ax, None))

        return fn

    def place_params(self, strategy: str = "2d", align_heads: bool = True) -> Model:
        """(Re)place the parameters on the mesh by ``param_pspecs(cfg, mesh,
        ..., strategy, align_heads)``; ``init`` and ``load_params`` use the
        last strategy given (``"2d"`` at first). Caches follow it too."""
        if self._sh is None:
            raise ValueError("place_params needs a mesh Model (build(cfg, mesh=...))")
        self.strategy, self.align_heads = strategy, align_heads
        if self.device.type != "meta":
            self._set_params(pr.unflatten((tuple(n.split(".")), act.full(t.detach()))
                                          for n, t in self.named_parameters()))
        return self

    def param_pspecs(self) -> Params:
        """The parameters' specs on the mesh (``sharding.rules``)."""
        return rules.param_pspecs(self.cfg, self._sh.mesh, self.param_shapes(), self.strategy,
                                  align_heads=self.align_heads)

    def distribute_params(self, params: Params) -> Params:
        """A tree of whole parameters (``master_params`` of an unsharded
        model, ``init_params``) placed on the mesh as ``place_params``
        places the module's."""
        return rules.distribute(params, self._sh.mesh, self.param_pspecs())

    def _use(self, tree):
        """Parameters (a tree, or one tensor) as a layer uses them: on a mesh the FSDP shards
        gathered (over 'pod' and 'data', and over 'model' too under the
        ``fsdp`` strategy, which has no tensor parallelism), the tensor-
        parallel shards kept; off a mesh the tree as it is. Called inside
        each block (and inside its remat), so each layer's weights are
        gathered when it runs, and the gradient's way back reduce-scatters
        them to the parameters' layout."""
        if self._sh is None:
            return tree
        from torch.distributed.tensor import Replicate

        names = self._sh.mesh.mesh_dim_names
        fsdp = {"pod", "data"} | ({"model"} if self.strategy == "fsdp" else set())

        def use(t):
            pl = [Replicate() if n in fsdp else p for n, p in zip(names, t.placements)]
            return t if pl == list(t.placements) else t.redistribute(self._sh.mesh, pl)

        if isinstance(tree, torch.Tensor):
            return use(tree)
        return pr.unflatten((path, use(t)) for path, t in pr.flatten(tree))

    def _place_batch(self, batch: Params) -> Params:
        """Off a mesh the batch as it is; on a mesh every leaf placed by
        ``batch_pspecs`` (a DTensor is redistributed, a plain tensor must
        lie on the mesh's device type)."""
        if self._sh is None:
            return batch
        specs = rules.batch_pspecs(self.cfg, self._sh.mesh, batch, self.strategy)
        return {k: rules.place(t, self._sh.mesh, specs[k]) for k, t in batch.items()}

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
        if self._sh is not None:
            tree = rules.distribute(tree, self._sh.mesh, self.param_pspecs())
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
        """The float32 masters' shapes as meta tensors, which allocate
        nothing (``params.shape_tree``)."""
        return pr.shape_tree(self.param_specs())

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
    def _embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of the embedding table. On a mesh each rank gathers the rows
        its shard of a vocab-split table holds (zeros elsewhere), a partial
        sum over the vocab axes that ``_constrain`` reduces: without the
        constraint every rank would hold (and compute on) the whole batch.
        (DTensor's own masked embedding cannot take the gradient that the
        constraint's backward hands it.)"""
        if self._sh is None:
            return table[tokens.long()]
        from torch.distributed.tensor import Partial, Replicate, Shard

        sh = self._sh
        names = sh.mesh.mesh_dim_names
        rows = rules.named(sh.mesh, (sh.batch(tokens.shape[0]),))
        vocab = [p == Shard(0) and r == Replicate() for p, r in zip(table.placements, rows)]
        t_pl = [Shard(0) if v else Replicate() for v in vocab]
        v_loc, chunk = table.shape[0], 0
        for i, v in enumerate(vocab):
            if v:
                v_loc //= sh.mesh.size(i)
                chunk = chunk * sh.mesh.size(i) + sh.coord(names[i])

        def pick(tb, tk):
            t = tk.long() - chunk * v_loc
            held = ((t >= 0) & (t < v_loc))[..., None]
            got = F.embedding(t.clamp(0, v_loc - 1), tb)
            return torch.where(held, got, torch.zeros((), dtype=got.dtype, device=got.device))

        out = sh.local(pick, (table, tokens), [t_pl, rows],
                       [Partial() if v else r for v, r in zip(vocab, rows)])
        return self._constrain(out)

    def _embed_in(self, params: Params, batch: Params) -> torch.Tensor:
        cfg = self.cfg
        dt = ly.cdtype(cfg)
        if cfg.modality == "audio":
            proj = self._use(params["frontend_proj"])
            return self._constrain(batch["frames"].to(dt) @ proj.to(dt))
        tok = self._embed(self._use(params["embed"]).to(dt), batch["tokens"])
        if cfg.modality == "vlm":
            return self._constrain(torch.cat([batch["patches"].to(dt), tok], dim=1))
        return tok

    def _unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        p = self._use({"final_ln": params["final_ln"], "unembed": params["unembed"]})
        x = ly.rmsnorm(p["final_ln"], x)
        return (x @ p["unembed"].to(x.dtype)).to(torch.float32)

    # --- backbone: one code path for forward AND prefill ----------------------
    def _recurrent(self, fn, params: Params, *tensors):
        """``fn(params, *tensors)``; on a mesh data-parallel (the xLSTM
        blocks and the recurrent decode steps)."""
        if self._sh is None:
            return fn(params, *tensors)
        return self._sh.data_parallel(fn, self._use(params), *tensors)

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
        sh, cp = self._sh, self._cp
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        prefix = cfg.n_patches if cfg.prefix_lm else 0
        if cfg.family in ("dense", "audio", "vlm"):
            def block(h, bp):
                out = ly.block_apply(cfg, self._use(bp), h, prefix_len=prefix, chunked=chunked,
                                     return_kv=collect, sh=sh, cp=cp)
                h, kv = out if collect else (out, None)
                return self._constrain_seq(h), kv

            kvs = []
            step = _maybe_remat(block, cfg)
            for bp in layers:
                x, kv = step(x, bp)
                kvs.append(kv)
            return x, aux, (kvs if collect else None)

        if cfg.family == "moe":
            wg, buf = self._wg_constrain(), self._buf_constrain()

            def moe_block(h, bp):
                h, aux1, kv = moe_mod.moe_block_apply(
                    cfg, self._use(bp), h, chunked=chunked, return_kv=collect, sh=sh, cp=cp,
                    wg_constrain=wg, buf_constrain=buf)
                return self._constrain_seq(h), aux1, kv

            kvs = []
            step = _maybe_remat(moe_block, cfg)
            for bp in layers:
                x, aux1, kv = step(x, bp)
                aux = aux + aux1
                kvs.append(kv)
            return x, aux / cfg.n_layers, (kvs if collect else None)

        if cfg.family == "ssm":
            def mlstm(mp, h):
                return xl.mlstm_apply(cfg, mp, h, return_cache=collect)

            def slstm(sp, h):
                return xl.slstm_apply(cfg, sp, h, return_cache=collect)

            def super_block(h, mlstms, slstm_p):
                mcs = []
                for mp in mlstms:
                    out = self._recurrent(mlstm, mp, h)
                    h, mc = out if collect else (out, None)
                    mcs.append(mc)
                out = self._recurrent(slstm, slstm_p, h)
                h, sc = out if collect else (out, None)
                return h, (mcs, sc)

            raw = []
            step = _maybe_remat(super_block, cfg)
            for mlstms, slstm_p in layers:
                x, sup = step(x, mlstms, slstm_p)
                raw.append(sup)
            return x, aux, (raw if collect else None)

        def group(h, mamba):
            out = ly.block_apply(cfg, self._use(params["shared_attn"]), h, chunked=chunked,
                                 return_kv=collect, sh=sh, cp=cp)
            h, kv = out if collect else (out, None)
            mcs = []
            for mp in mamba:
                out = ssm_mod.mamba2_apply(cfg, self._use(mp), h, return_cache=collect, sh=sh)
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
        with self._mesh_ctx():
            x = self._embed_in(params, self._place_batch(batch))
            chunked = _auto_chunked(chunked_attn, x.shape[1])
            x, aux, _ = self._backbone(params, layers, x, chunked=chunked, collect=False)
            return self._unembed(params, x), aux

    # --- training: an explicit float32 master tree, cast inside autograd ------
    def apply(self, params: Params, batch: Params, *, chunked_attn: bool | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """The reference's ``forward(params, batch)``: (logits (B,S,V) f32,
        aux loss scalar) from the float32 masters ``params`` (nested in the
        reference's paths); gradients reach them through the casts. On a
        mesh ``params`` are DTensors (``distribute_params``)."""
        with self._mesh_ctx():
            tree, layers = self._to_compute(pr.flatten(params))
            x = self._embed_in(tree, self._place_batch(batch))
            chunked = _auto_chunked(chunked_attn, x.shape[1])
            x, aux, _ = self._backbone(tree, layers, x, chunked=chunked, collect=False)
            return self._unembed(tree, x), aux

    def _nll(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """-log_softmax(logits)[targets] (float32). On a mesh whose logits
        are split over the vocabulary the log-sum-exp reduces across the
        shards, and each rank picks the target logits it holds (the rest
        add 0 in the all-reduce), as GSPMD partitions the reference's."""
        from torch.distributed.tensor import Partial, Replicate, Shard

        if self._sh is None or Shard(2) not in logits.placements:
            logp = torch.log_softmax(logits, dim=-1)
            return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
        sh = self._sh
        names = sh.mesh.mesh_dim_names
        rows = [Shard(0) if sh.batch(logits.shape[0]) and n in sh.act_axes else Replicate()
                for n in names]
        pl = [Shard(2) if p == Shard(2) else r for p, r in zip(logits.placements, rows)]
        logits = logits.redistribute(sh.mesh, pl)   # a partial sum (fsdp rows) reduced
        v_loc = logits.to_local().shape[-1]
        chunk = 0
        for i, p in enumerate(pl):
            if p == Shard(2):
                chunk = chunk * sh.mesh.size(i) + sh.coord(names[i])
        rows = [Shard(0) if r == Shard(0) else Replicate() for r in rows]
        # Each reduction over the vocab placed back on the rows explicitly
        # (an all-reduce): left to itself DTensor reduce-scatters the rows
        # over 'model', and the gradient's way back then gathers the logits.
        m = logits.detach().amax(dim=-1, keepdim=True).redistribute(sh.mesh, rows)
        se = torch.sum(torch.exp(logits - m), dim=-1).redistribute(sh.mesh, rows)
        lse = torch.log(se) + m[..., 0]

        def pick(lg, tg):
            t = tg.long() - chunk * v_loc
            held = (t >= 0) & (t < v_loc)
            val = torch.gather(lg, -1, t.clamp(0, v_loc - 1)[..., None])[..., 0]
            return torch.where(held, val, torch.zeros((), dtype=val.dtype, device=val.device))

        picked = sh.local(pick, (logits, targets), [pl, rows],
                          [Partial() if p == Shard(2) else r for p, r in zip(pl, rows)])
        return lse - picked.redistribute(sh.mesh, rows)

    def loss(self, params: Params, batch: Params) -> tuple[torch.Tensor, Params]:
        """(total, {"ce", "aux"}): the mean next-token cross-entropy from a
        float32 log-softmax (over ``batch["mask"]``'s positions when given,
        divided by max(sum(mask), 1), as for the audio modality's masked
        frames; over the text positions for the vlm modality) plus
        ``router_aux_weight * aux``."""
        cfg = self.cfg
        batch = self._place_batch(batch)
        logits, aux = self.apply(params, batch)
        with self._mesh_ctx():
            if cfg.modality == "vlm":  # loss only over the text positions
                logits = logits[:, cfg.n_patches:, :]
            nll = self._nll(logits, batch["targets"])
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
        """Zeros of ``cache_shapes``; on a mesh DTensors placed by
        ``cache_pspecs`` (each rank allocates its shard only)."""
        shapes = self.cache_shapes(batch, max_seq)
        if self._sh is None:
            return pr.unflatten((path, torch.zeros(s.shape, dtype=s.dtype, device=self.device))
                                for path, s in pr.flatten(shapes))
        from torch.distributed.tensor import zeros as dzeros

        specs = dict(pr.flatten(rules.cache_pspecs(self.cfg, self._sh.mesh, shapes, batch,
                                                   self.strategy)))
        return pr.unflatten(
            (path, dzeros(s.shape, dtype=s.dtype, device_mesh=self._sh.mesh,
                          placements=rules.named(self._sh.mesh, specs[path])))
            for path, s in pr.flatten(shapes))

    # --- prefill: ONE pass producing last-token logits AND the decode cache ----
    @torch.no_grad()
    def prefill(self, batch: Params, max_seq: int, *,
                chunked_attn: bool | None = None) -> tuple[torch.Tensor, Params]:
        """Hybrid and ssm prompts have at least ``ssm_conv - 1`` tokens (see
        ``models.ssm``, ``models.xlstm``). The vlm batch's patches count in
        the cache's positions."""
        params, layers = self.compute_params()
        with self._mesh_ctx():
            x = self._embed_in(params, self._place_batch(batch))
            b, s, _ = x.shape
            chunked = _auto_chunked(chunked_attn, s)
            x, _, raw = self._backbone(params, layers, x, chunked=chunked, collect=True)
            logits = self._unembed(params, x[:, -1:, :])
            cache = self.init_cache(b, max_seq)
            cache["pos"].fill_(s)
            if self.cfg.family in _BLOCK_FAMILIES:
                _write_kv(cache["layers"], raw, s, self._sh)
                return logits, cache
            if self.cfg.family == "ssm":
                ml, sl = cache["supers"]["mlstm"], cache["supers"]["slstm"]
                for j, (mcs, sc) in enumerate(raw):
                    for i, mc in enumerate(mcs):
                        for name, t in mc.items():
                            act.assign(ml[name][j, i], t)
                    for name, t in sc.items():
                        act.assign(sl[name][j], t)
                return logits, cache
            _write_kv(cache["attn"], [kv for kv, _ in raw], s, self._sh)
            for site, (_, mcs) in zip(self._mamba_sites(cache), raw):
                for i, mc in enumerate(mcs):
                    for name, t in mc.items():
                        act.assign(site[name][i], t)
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
        sh = self._sh
        with self._mesh_ctx():
            x = self._embed(self._use(params["embed"]).to(ly.cdtype(cfg)),
                            self._place_batch(batch)["tokens"])
            pos = cache["pos"]
            if cfg.family in _BLOCK_FAMILIES:
                k_all, v_all = cache["layers"]["k"], cache["layers"]["v"]
                decode = moe_mod.moe_block_decode if cfg.family == "moe" else ly.block_decode
                for i, bp in enumerate(layers):
                    x, _ = decode(cfg, self._use(bp), x, {"k": k_all[i], "v": v_all[i]}, pos,
                                  sh=sh)
                new_cache = {"layers": {"k": k_all, "v": v_all}, "pos": pos + 1}
                return self._unembed(params, x), new_cache

            def recurrent(step, p, h, leaves: dict):
                """One recurrent block's decode; its new cache written into
                ``leaves`` (views of the stacked cache)."""
                if sh is None:
                    h, new = step(cfg, p, h, leaves)
                    for n, t in new.items():
                        leaves[n].copy_(t)
                    return h
                names = sorted(leaves)
                h, new = self._recurrent(
                    lambda pp, hh, *ts: step(cfg, pp, hh, dict(zip(names, ts))),
                    p, h, *(leaves[n] for n in names))
                for n in names:
                    act.assign(leaves[n], new[n])
                return h

            if cfg.family == "ssm":
                ml, sl = cache["supers"]["mlstm"], cache["supers"]["slstm"]
                for j, (mlstms, slstm) in enumerate(layers):
                    for i, mp in enumerate(mlstms):
                        x = recurrent(xl.mlstm_decode, mp, x, {n: t[j, i] for n, t in ml.items()})
                    x = recurrent(xl.slstm_decode, slstm, x, {n: t[j] for n, t in sl.items()})
                new_cache = {"supers": cache["supers"], "pos": pos + 1}
                return self._unembed(params, x), new_cache

            k_all, v_all = cache["attn"]["k"], cache["attn"]["v"]
            for j, (group, site) in enumerate(zip(layers, self._mamba_sites(cache))):
                x, _ = ly.block_decode(cfg, self._use(params["shared_attn"]), x,
                                       {"k": k_all[j], "v": v_all[j]}, pos, sh=sh)
                for i, mp in enumerate(group):
                    x = recurrent(ssm_mod.mamba2_decode, mp, x, {n: t[i] for n, t in site.items()})
            new_cache = {k: v for k, v in cache.items() if k != "pos"}
            new_cache["pos"] = pos + 1
            return self._unembed(params, x), new_cache


def _write_kv(dst: Params, kvs: list, s: int, sh=None) -> None:
    """Write each layer's (or site's) full-sequence (k, v) (B, S, K, hd)
    into the stacked cache leaves dst["k"], dst["v"] (L, B, S_cache, K,
    hd): zero-padded to S_cache, or, when S_cache < S (sliding), the last
    S_cache positions rolled so that absolute position p sits in slot p %
    S_cache. On a mesh (``sh``) each (k, v) is padded or rolled on the
    local shards of its rows and heads, then placed as the cache is and
    copied into the cache's local shard."""
    s_cache = dst["k"].shape[2]

    def fill(t):
        if s_cache >= s:
            return F.pad(t, (0, 0, 0, 0, 0, s_cache - s))
        return torch.roll(t[:, s - s_cache:], s % s_cache, dims=1)

    for i, (k, v) in enumerate(kvs):
        for name, t in (("k", k), ("v", v)):
            out = dst[name][i]
            if sh is not None:
                spec = (sh.batch(t.shape[0]), None, sh.heads(t.shape[2]))
                act.assign(out, sh.local(fill, (t,), [spec], spec).to(out.dtype))
            elif s_cache >= s:
                out[:, :s].copy_(t)
            else:
                shift = s % s_cache  # position s - s_cache sits at slot shift
                out.copy_(torch.roll(t[:, s - s_cache:], shift, dims=1))


def build(cfg: ArchConfig, act_axes: tuple | None = None, mesh: Any = None,
          seq_shard: bool = False, context_parallel: bool = False,
          moe_wg: bool = False) -> Model:
    return Model(cfg, act_axes, mesh, seq_shard, context_parallel, moe_wg)


def for_shape(cfg: ArchConfig, shape_name: str) -> ArchConfig:
    """long_500k needs sub-quadratic attention: dense/moe/vlm switch to the
    sliding-window VARIANT (not the published config)."""
    if (shape_name == "long_500k" and cfg.attention == "full"
            and cfg.family in ("dense", "moe", "vlm")):
        return dataclasses.replace(cfg, attention="sliding")
    return cfg
