"""ctypes wrapper of K6, ``csrc/ssd_chunks.cu`` (replaces the Pallas
``repro/kernels/ssd/kernel.py::ssd_chunks``).

One kernel source, three modes:

- ``ssd_chunks``: the TPU kernel's function, y and the state of every
  chunk given the state entering it, on its (BH, NC, L, 64) layout;
- ``ssd_chunk_states``: pass 1 of the scan, the state of every chunk
  entering with no state (no q, no h_in, no y);
- ``ssd_chunk_outputs``: pass 2, y given the state entering each chunk
  (no state written).

The modes take the grouped layout: q and k (G, NC, L, Dk), one row per
group (a batch row: the heads of a row share B and C); v (G, NC, L, Hg, Dv)
and ld (G, NC, L, Hg), read at their strides (the model's (B, S, H, P) and
(B, S, H) viewed per chunk); h_in and the state (G, Hg, NC, Dk, Dv)
float32; y (G, NC, L, Hg, Dv) contiguous. Dk and Dv (the SSD state and head
sizes) are at most 64, as in every config; like the Pallas kernel, the
kernel takes any such sizes. bf16 at Dk = Dv = 64 (the published widths)
runs the tensor-core body, which reads q, k and v through TMA tensor maps,
so their strides must be multiples of 16 bytes; float32, and bf16 at other
sizes (the reduced configs'), run the CUDA-core body.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

LAUNCHES = 0
MAX_DIM = 64      # Dk, Dv
TMA_DIM = 64      # Dk = Dv of the bf16 tensor-core body
MAX_CHUNK = 256   # L
FULL, STATES, OUTPUTS = 0, 1, 2  # the modes of csrc/ssd_chunks.cu
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.POINTER(ctypes.c_longlong)
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _P]
_TYPES = {torch.bfloat16: 1, torch.float32: 0}


def _tma(t: torch.Tensor, dk: int, dv: int) -> bool:
    """Whether a launch on ``t``'s type at these sizes runs the TMA body."""
    return t.dtype == torch.bfloat16 and dk == dv == TMA_DIM


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device, align: int) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"ssd_chunks kernel: {name} must be on the CUDA device {device}, "
                         f"got {t.device}")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"ssd_chunks kernel: {name} {tuple(t.shape)} {t.dtype}, expected "
                         f"{tuple(shape)} {dtype}")
    if t.data_ptr() % align:
        raise ValueError(f"ssd_chunks kernel: {name} must start on a {align}-byte boundary")


def _strides(name: str, t: torch.Tensor, tma: bool) -> list[int]:
    """Element strides of all but t's last dimension, which must be
    contiguous; for q, k, v and y read or written by TMA every stride a
    multiple of 16 bytes. A dimension of size 1 gets the stride of a
    contiguous layout."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"ssd_chunks kernel: {name}'s last dimension must be contiguous, "
                         f"got strides {t.stride()}")
    out = [t.stride(i) if t.shape[i] > 1 else math.prod(t.shape[i + 1:])
           for i in range(t.dim() - 1)]
    if name != "ld" and tma and any(s * 2 % 16 for s in out):
        raise ValueError(f"ssd_chunks kernel: {name} strides {t.stride()} of "
                         f"{tuple(t.shape)} are not multiples of 16 bytes")
    return out


def _arguments(mode: int, q: torch.Tensor | None, k: torch.Tensor, v: torch.Tensor,
               ld: torch.Tensor, h_in: torch.Tensor | None, y: torch.Tensor | None,
               state: torch.Tensor | None) -> list:
    """``repro_ssd_chunks``'s arguments for one launch of ``mode`` on the
    grouped layout (see the module docstring), each tensor checked; q and
    h_in only where the mode reads them."""
    if mode == STATES and (q is not None or h_in is not None):
        raise ValueError("ssd_chunks kernel: the states mode reads neither q nor h_in")
    if k.dim() != 4 or v.dim() != 5:
        raise ValueError(f"ssd_chunks kernel: k must be (G, NC, L, Dk) and v (G, NC, L, Hg, "
                         f"Dv), got {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype not in _TYPES or not k.is_cuda:
        raise ValueError(f"ssd_chunks kernel: takes bfloat16 or float32 tensors on CUDA, got "
                         f"k {k.dtype} on {k.device}")
    g, nc, l, dk = k.shape
    hg, dv = v.shape[3:]
    if (not 0 < dk <= MAX_DIM or not 0 < dv <= MAX_DIM or not 0 < l <= MAX_CHUNK
            or g * nc * hg == 0):
        raise ValueError(f"ssd_chunks kernel: takes 0 < Dk, Dv <= {MAX_DIM}, 0 < L <= "
                         f"{MAX_CHUNK} and nonempty G, NC, Hg, got k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    dev, dt = k.device, k.dtype
    tma = _tma(k, dk, dv)
    qk_shape, v_shape, h_shape = (g, nc, l, dk), (g, nc, l, hg, dv), (g, hg, nc, dk, dv)
    wants_y = mode != STATES
    wants_state = mode != OUTPUTS
    tensors = [("k", k, qk_shape, dt), ("v", v, v_shape, dt), ("ld", ld, (g, nc, l, hg), dt)]
    if wants_y:
        tensors += [("q", q, qk_shape, dt), ("y", y, v_shape, dt),
                    ("h_in", h_in, h_shape, torch.float32)]
    if wants_state:
        tensors.append(("state", state, h_shape, torch.float32))
    for name, t, shape, dtype in tensors:
        if t is None:
            raise ValueError(f"ssd_chunks kernel: mode {mode} needs {name}")
        _check(name, t, shape, dtype, dev, 16 if tma else t.element_size())
        if name in ("h_in", "state") and not t.is_contiguous():
            raise ValueError(f"ssd_chunks kernel: {name} must be contiguous")
    strides = ((_strides("q", q, tma) if wants_y else [0] * 3) + _strides("k", k, tma)
               + _strides("v", v, tma) + (_strides("y", y, tma) if wants_y else [0] * 4)
               + _strides("ld", ld.unsqueeze(-1), tma))
    return [q.data_ptr() if wants_y else None, k.data_ptr(), v.data_ptr(), ld.data_ptr(),
            h_in.data_ptr() if wants_y else None, y.data_ptr() if wants_y else None,
            state.data_ptr() if wants_state else None,
            (ctypes.c_longlong * 6)(g, hg, nc, l, dk, dv), (ctypes.c_longlong * 18)(*strides),
            mode, _TYPES[dt], dev.index,
            build.stream_of(k)]


def _run(args: list) -> None:
    global LAUNCHES
    build.check(build.function("repro_ssd_chunks", _ARGTYPES)(*args), "ssd_chunks")
    LAUNCHES += 1


def launch(mode: int, q: torch.Tensor | None, k: torch.Tensor, v: torch.Tensor,
           ld: torch.Tensor, h_in: torch.Tensor | None, y: torch.Tensor | None,
           state: torch.Tensor | None) -> None:
    """One launch of ``mode`` on the grouped layout (see the module
    docstring), writing ``y`` and / or ``state``. The states mode takes
    neither q nor h_in (None)."""
    _run(_arguments(mode, q, k, v, ld, h_in, y, state))


def ssd_chunks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
               h_in: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q, k: contiguous (BH, NC, L, Dk), v: (BH, NC, L, Dv) of one type
    (bfloat16 or float32), ld: contiguous (BH, NC, L) of that type, h_in:
    contiguous (BH, NC, Dk, Dv) float32, all on one CUDA device, 1 <= L <=
    256, Dk, Dv <= 64. Returns (y (BH, NC, L, Dv) of q's type, state_out
    (BH, NC, Dk, Dv) float32): the SSD step of every chunk, given the state
    entering it."""
    for name, t in (("q", q), ("k", k), ("v", v), ("ld", ld), ("h_in", h_in)):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"ssd_chunks kernel: {name} must be contiguous on CUDA, got "
                             f"{t.dtype} on {t.device}")
    if q.dim() != 4 or ld.dim() != 3 or h_in.dim() != 4:
        raise ValueError(f"ssd_chunks kernel: q must be (BH, NC, L, Dk), got {tuple(q.shape)}")
    y = torch.empty_like(v)
    state = torch.empty_like(h_in)
    launch(FULL, q, k, v.unsqueeze(3), ld.unsqueeze(3), h_in.unsqueeze(1), y.unsqueeze(3),
           state.unsqueeze(1))
    return y, state


def ssd_chunk_states(k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor) -> torch.Tensor:
    """k (G, NC, L, Dk), v (G, NC, L, Hg, Dv), ld (G, NC, L, Hg) of one type
    on one CUDA device -> (G, Hg, NC, Dk, Dv) float32: each chunk's state
    entering with no state, sum_l exp(cum_L - cum_l) k_l v_l^T."""
    g, nc, _, dk = k.shape
    state = torch.empty((g, v.shape[3], nc, dk, v.shape[-1]), dtype=torch.float32,
                        device=k.device)
    launch(STATES, None, k, v, ld, None, None, state)
    return state


def ssd_chunk_outputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
                      h_in: torch.Tensor) -> torch.Tensor:
    """q, k (G, NC, L, Dk), v (G, NC, L, Hg, Dv), ld (G, NC, L, Hg) of one
    type and h_in (G, Hg, NC, Dk, Dv) float32, the state entering each
    chunk, on one CUDA device -> y (G, NC, L, Hg, Dv) of q's type,
    contiguous."""
    y = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    launch(OUTPUTS, q, k, v, ld, h_in, y, None)
    return y


def _states_handed_h_in(k: torch.Tensor, v: torch.Tensor, ld: torch.Tensor,
                        h_in: torch.Tensor) -> torch.Tensor:
    """The states mode launched with ``h_in``'s address where ``launch``
    passes none: the kernel must not read it, so the result must be
    ``ssd_chunk_states(k, v, ld)`` bit for bit (chip_smoke.py's check that
    pass 1 ignores the incoming state; nothing on the model's path calls it)."""
    g, nc, _, dk = k.shape
    state = torch.empty((g, v.shape[3], nc, dk, v.shape[-1]), dtype=torch.float32,
                        device=k.device)
    _check("h_in", h_in, state.shape, torch.float32, k.device, 16)
    args = _arguments(STATES, None, k, v, ld, None, None, state)
    args[4] = h_in.data_ptr()
    _run(args)
    return state
