"""A dense step captured once as a CUDA graph and replayed.

The dense torch step is some hundreds of small kernels; at the boxes the
multiphase classes run (40^3) each takes microseconds on the card and the
host's launch of it takes longer, so an eager step is bound by the launches.
A graph replays the whole step (and the copy of its result back into its
input buffers) in one call, with the same kernels in the same order: its
state is the eager step's bit for bit.

The step must be a function of its state tensors only: nothing it reads may
change between replays except those tensors (the step count of a case with
'series' boundaries is not a tensor, so such cases step eagerly).
"""

from __future__ import annotations

from typing import Callable

import torch


class StepGraph:
    """fn(*state) -> new state (a tuple of tensors of the state's shapes and
    dtypes), captured on the state's CUDA device."""

    def __init__(self, fn: Callable, state: tuple):
        self.buf = tuple(s.detach().clone() for s in state)
        side = torch.cuda.Stream(device=self.buf[0].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*self.buf)               # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            out = fn(*self.buf)
            for b, o in zip(self.buf, out):
                b.copy_(o)

    def run(self, state: tuple, n_steps: int) -> tuple:
        """n_steps replays from `state`; returns the new state (tensors of
        the caller's own, not the graph's buffers)."""
        for b, s in zip(self.buf, state):
            b.copy_(s)
        for _ in range(int(n_steps)):
            self.graph.replay()
        return tuple(b.clone() for b in self.buf)


def graphable(cc, graph) -> bool:
    """Whether a dense step of compiled case `cc` replays as a graph: on a
    CUDA device, without 'series' boundaries, unless graph is False (None:
    the default, True on CUDA)."""
    if graph is False or cc.device.type != "cuda":
        return False
    return not any(bc.u_mode == "series" for bc in cc.bcs)


__all__ = ["StepGraph", "graphable"]
