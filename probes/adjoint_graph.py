#!/usr/bin/env python3
"""The adjoint rollout's CUDA-graph route against its eager route on one
card (engine/adjoint.rollout graph=None against graph=False):

  1. poiseuille n=12 with a windkessel outlet: the 60-step rollout's state
     (bit for bit) and d P_c / d log Rd (printed side by side);
  2. demo_adjoint's default case (coronary 96x96x120 r=7, four RCR
     outlets): s for one value and gradient of the split loss through a
     STEPS-step rollout (remat chunk 30) on the graph route (first with
     its captures, then again) and the eager route, the peak device
     memory, the loss and gradient of each, and a forward-only rollout on
     each route.

    python3 probes/adjoint_graph.py [STEPS]   # default 120; needs a card
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from lbm_tpu_torch.cases import get_case  # noqa: E402
from lbm_tpu_torch.engine import adjoint  # noqa: E402
from lbm_tpu_torch.engine.compile import compile_case  # noqa: E402


def value_and_grad(cc, steps, chunk, graphs, loss_of):
    """graphs: a RolloutGraphs (the graph route) or None (the eager
    route)."""
    base = torch.from_numpy(adjoint.wk_params(cc)).to(cc.device)
    x = torch.log(base[:, 2]).requires_grad_(True)
    theta = torch.cat([base[:, :2], torch.exp(x)[:, None]], dim=1)
    f, wk = adjoint.rollout(cc, theta, steps, remat_chunk=chunk,
                            graph=None if graphs else False, graphs=graphs)
    loss = loss_of(cc, f, wk)
    (g,) = torch.autograd.grad(loss, x)
    torch.cuda.synchronize()
    return float(loss.detach()), g.cpu().tolist(), f.detach(), wk.detach()


def main() -> int:
    steps = int(sys.argv[1]) if sys.argv[1:] else 120
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), flush=True)
    cc = compile_case(get_case("poiseuille", n=12,
                               windkessel=(5e-4, 24000.0, 2.5e-3)), dev)

    def pc(cc, f, wk):
        return wk[0]

    eager = value_and_grad(cc, 60, 20, None, pc)
    graph = value_and_grad(cc, 60, 20, adjoint.RolloutGraphs(cc), pc)
    same = torch.equal(eager[2], graph[2]) and torch.equal(eager[3], graph[3])
    print(f"poiseuille n=12, 60 steps: state bit for bit {same}; P_c eager "
          f"{eager[0]!r} graph {graph[0]!r}; gradient eager {eager[1]} "
          f"graph {graph[1]}", flush=True)

    cc = compile_case(get_case("coronary", shape=(96, 96, 120), radius=7,
                               windkessel=[(1e-4, 5e3, 2e-3)] * 4), dev)
    target = torch.tensor([0.40, 0.27, 0.20, 0.13], device=dev)

    def split_loss(cc, f, wk):
        return torch.sum((adjoint.flow_split(cc, f) - target) ** 2)

    graphs = adjoint.RolloutGraphs(cc)
    for name, g_ in (("graph (capture)", graphs), ("graph", graphs),
                     ("eager", None)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, g, f, _ = value_and_grad(cc, steps, 30, g_, split_loss)
        s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"coronary 96x96x120, {steps} steps, {name}: value and "
              f"gradient {s:.2f} s ({s / steps * 1e3:.2f} ms/step), peak "
              f"{peak:.2f} GiB, loss {loss!r}, gradient {g}", flush=True)
    with torch.no_grad():
        base = torch.from_numpy(adjoint.wk_params(cc)).to(dev)
        for graph in (None, False):
            t0 = time.perf_counter()
            adjoint.rollout(cc, base, steps, remat_chunk=30, graph=graph,
                            graphs=graphs if graph is None else None)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            print(f"forward only, graph={graph}: {s:.2f} s "
                  f"({s / steps * 1e3:.3f} ms/step)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
