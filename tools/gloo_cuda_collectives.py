"""Which collectives a gloo world carries for CUDA tensors, in the form
DTensor issues them (``torch.distributed._functional_collectives``).

Two ranks share cuda:0 (gloo stages CUDA tensors through host memory).
Each collective runs in a world of its own, so one that crashes its
ranks (a segmentation fault ends the processes) does not hide the rest.
Prints one line per collective: ``ok`` with the result, the error, or how
the ranks ended. Card only (~1 min):

    python3 tools/gloo_cuda_collectives.py
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_to_all_single")


def one_collective(rank: int, device, name: str):
    import torch
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("x",))
    x = torch.arange(8.0, device="cuda") + rank
    fn = {"all_reduce": lambda: funcol.all_reduce(x, "sum", mesh),
          "all_gather_into_tensor": lambda: funcol.all_gather_tensor(x, 0, mesh),
          "reduce_scatter_tensor": lambda: funcol.reduce_scatter_tensor(x, "sum", 0, mesh),
          "all_to_all_single": lambda: funcol.all_to_all_single(x, None, None, mesh)}[name]
    out = fn()
    out = out.wait() if hasattr(out, "wait") else out
    torch.cuda.synchronize()
    return out.cpu().tolist()


def main() -> int:
    import torch

    from repro_torch.launch import mesh as mesh_lib

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for name in COLLECTIVES:
        res = mesh_lib.spawn_world(one_collective, 2, backend="gloo", device="cuda",
                                   args=(name,), timeout_s=120.0)
        if res.errors:
            why = "; ".join(f"rank {r}: {e.strip().splitlines()[-1][:200]}"
                            for r, e in sorted(res.errors.items()))
            print(f"gloo on CUDA tensors: {name}: FAILS ({why})")
        else:
            print(f"gloo on CUDA tensors: {name}: ok {res.results[0]}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
