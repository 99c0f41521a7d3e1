"""Process worlds and device meshes: the counterpart of
``repro.launch.mesh`` over ``torch.distributed``.

``make_production_mesh`` builds the dry run's 16x16 or 2x16x16
``DeviceMesh`` on a fake world (no process, no card; see
``launch.dryrun``), and the module's constants are the roofline's
hardware model, the NVIDIA H100 SXM's.

A world is one process per map task (a rank) on this host.
``spawn_world(fn, n_ranks, backend=...)`` starts the ranks from a fresh
interpreter each (``spawn``), hosts their rendezvous store, initializes
the process group on every rank with the named backend, puts rank r on
``cuda:{r % device_count}`` (or on the CPU when asked), calls
``fn(rank, device, *args)`` and destroys the group when ``fn`` returns
or raises. The ranks split the caller's intra-op threads between them. Each rank's return value comes back to the caller, and a
rank's exception comes back as its traceback with a nonzero
``returncode``. Then ``make_host_mesh`` gives a rank its
``DeviceMesh``. ``local_world`` makes this process the one rank of a
world and gives its (1, 1) mesh.

Backends are explicit; nothing is switched for the caller:

  * ``nccl`` needs one card per rank and CUDA ranks; asked for more
    ranks than cards it raises and names ``gloo``.
  * ``gloo`` serves CPU ranks, and ranks that share one card (it stages
    CUDA tensors through host memory itself, see
    ``core.mapreduce.all_gather_tree``).

The map always runs on the rank's device.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import multiprocessing
import os
import pickle
import queue
import time
import traceback
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
_HOST = "127.0.0.1"
# Seconds the other ranks get to finish once one has failed.
_GRACE_S = 30.0


# Hardware constants for the roofline: the NVIDIA H100 SXM5 80GB, per card.
# Dense bf16 tensor-core peak, without sparsity (H100 data sheet: 1979
# TFLOPS is the 2:4-sparse figure).
PEAK_FLOPS_BF16 = 989e12
# HBM3 bandwidth (H100 SXM5 data sheet: 3.35 TB/s).
HBM_BW = 3.35e12
# HBM capacity (80 GB).
HBM_BYTES = 80e9
# The collective model's one link rate, bytes/s per card. A 16-wide mesh
# axis spans two 8-card nodes, so its ring crosses the inter-node network:
# one NDR InfiniBand port of 400 Gb/s per GPU (DGX H100 reference
# architecture) = 50e9 B/s. (NVLink inside a node, 450 GB/s a direction,
# is not the limit of such a ring.)
INTER_NODE_BW = 50e9


def make_fake_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    """A CPU ``DeviceMesh`` of ``shape`` over a fake world
    (``backend="fake"``: one process stands for every rank, and collectives
    return without moving data, so tensors under ``FakeTensorMode`` trace
    a step as rank 0 of the mesh). The world is initialized here when none
    is; an initialized world of another size raises."""
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh {shape} needs a world of {n} ranks; the initialized world "
                           f"has {dist.get_world_size()}")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """The production ``DeviceMesh`` on a fake world (``make_fake_mesh``):
    (16, 16) over ("data", "model") or, with ``multi_pod``, (2, 16, 16) over
    ("pod", "data", "model") -- the reference's shapes and axis names, so
    the sharding rules compare one for one with the JAX package's."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_fake_mesh((16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of dims ``("data", "model")`` over the initialized
    world of ``data * model`` ranks (rank r at data index r // model).
    Raises if no world is initialized or the sizes do not match it."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh needs an initialized torch.distributed world "
            "(start the ranks with repro_torch.launch.mesh.spawn_world)"
        )
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"mesh ({data}, {model}) needs {data * model} ranks; the world has {world}")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def local_world(backend: str, device_type: str = "cuda"):
    """A world of one rank in this process (no new process: this process is
    rank 0 of 1, its store on a free local port) and its (1, 1)
    ``make_host_mesh``; the world is destroyed on exit. The one-process form
    of a mesh of one device along ``data``. Raises if a world is already
    initialized."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: pass one of {BACKENDS}")
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed world is already initialized in this process")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = dist.TCPStore(_HOST, 0, world_size=1, is_master=True,
                          timeout=datetime.timedelta(seconds=300))
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1, device_type=device_type)
    finally:
        dist.destroy_process_group()


class WorldResult(NamedTuple):
    """What ``spawn_world`` brings back: each rank's return value (None
    where the rank failed) and, per failed rank, its traceback or how its
    process ended."""

    results: list
    errors: dict[int, str]

    @property
    def returncode(self) -> int:
        return 1 if self.errors else 0

    def check(self) -> list:
        """The results, or a ``RuntimeError`` carrying every failed rank's
        traceback."""
        if self.errors:
            raise RuntimeError("\n".join(
                f"rank {r} failed:\n{tb}" for r, tb in sorted(self.errors.items())
            ))
        return self.results


def _to_host(obj: Any) -> Any:
    """Tensors inside tuples, named tuples, lists and dicts -> CPU copies."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, n_ranks: int, backend: str, device_type: str, threads: int,
               port: int, timeout_s: float, fn: Callable, args: tuple, results) -> None:
    """One rank: join the world, run ``fn``, report, leave."""
    try:
        # Every rank runs on this host: the backends' sockets go over the
        # loopback device unless the caller's environment names another.
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        # The ranks share the caller's cores: each takes an equal share of
        # the caller's intra-op threads (more threads than cores in all
        # stalls every rank at OpenMP barriers).
        torch.set_num_threads(threads)
        if device_type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        timeout = datetime.timedelta(seconds=timeout_s)
        store = dist.TCPStore(_HOST, port, is_master=False, timeout=timeout)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n_ranks,
                                timeout=timeout)
        try:
            out = fn(rank, device, *args)
        finally:
            dist.destroy_process_group()
        # Plain pickle: tensor bytes travel inside the message, so nothing
        # of this process has to outlive it.
        results.put((rank, True, pickle.dumps(_to_host(out))))
    except BaseException:
        results.put((rank, False, pickle.dumps(traceback.format_exc())))
        raise


def spawn_world(
    fn: Callable,
    n_ranks: int,
    *,
    backend: str,
    device: str | torch.device = "cuda",
    args: tuple = (),
    timeout_s: float = 900.0,
) -> WorldResult:
    """Run ``fn(rank, device, *args)`` on ``n_ranks`` new processes joined
    in one ``torch.distributed`` world; returns every rank's result.

    ``fn`` and ``args`` are pickled into the ranks, so ``fn`` is a
    module-level function; results come back as CPU copies of their
    tensors. A rank that raises reports its traceback; once one rank has
    failed, the others get ``_GRACE_S`` seconds to finish (a rank waiting
    in a collective for the failed one never would) and are then
    terminated, as is every rank still running after ``timeout_s``.
    Every process started here has ended when this returns.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: pass one of {BACKENDS}")
    if n_ranks < 1:
        raise ValueError(f"n_ranks={n_ranks} must be >= 1")
    device_type = torch.device(device).type
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and (device_type != "cuda" or n_ranks > n_cards):
        raise ValueError(
            f"backend='nccl' needs one CUDA card per rank: {n_ranks} ranks on "
            f"{device_type} with {n_cards} cards visible; use backend='gloo' for CPU "
            "ranks or for ranks that share a card"
        )
    if device_type == "cuda" and n_cards == 0:
        raise RuntimeError("no CUDA card is visible; pass device='cpu' for CPU ranks")

    threads = max(1, torch.get_num_threads() // n_ranks)
    store = dist.TCPStore(_HOST, 0, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, name=f"rank{r}", args=(
            r, n_ranks, backend, device_type, threads, store.port, timeout_s, fn, args,
            results))
        for r in range(n_ranks)
    ]
    for p in procs:
        p.start()
    out: list = [None] * n_ranks
    errors: dict[int, str] = {}
    pending = set(range(n_ranks))
    deadline = time.monotonic() + timeout_s
    limit = f"no result within timeout_s={timeout_s:g} s"  # the limit that ends the wait
    gone_since: dict[int, float] = {}
    try:
        while pending:
            now = time.monotonic()
            if errors and now + _GRACE_S < deadline:
                deadline = now + _GRACE_S
                limit = (f"no result within the {_GRACE_S:g} s grace period after "
                         f"rank {min(errors)} failed")
            if now > deadline:
                for r in pending:
                    errors[r] = f"{limit}; terminated"
                break
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue.Empty:
                for r in list(pending):
                    if procs[r].exitcode is None:
                        continue
                    # Ended without a message still in the queue: give its
                    # last put a moment to arrive before calling it lost.
                    if now - gone_since.setdefault(r, now) > 5.0:
                        errors[r] = f"process ended with exit code {procs[r].exitcode} and no result"
                        pending.discard(r)
                continue
            pending.discard(rank)
            if ok:
                out[rank] = pickle.loads(payload)
            else:
                errors[rank] = pickle.loads(payload)
    finally:
        # A rank that reported leaves at once; one still pending is stuck
        # (or the caller was interrupted) and is stopped.
        for r, p in enumerate(procs):
            p.join(timeout=0.0 if r in pending else 10.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return WorldResult(out, errors)


__all__ = ["BACKENDS", "HBM_BW", "HBM_BYTES", "INTER_NODE_BW", "PEAK_FLOPS_BF16", "WorldResult",
           "local_world", "make_fake_mesh", "make_host_mesh", "make_production_mesh",
           "spawn_world"]
