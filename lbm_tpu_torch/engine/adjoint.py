"""Differentiable (adjoint) solver route: torch.autograd through the
rollout (torch port of lbm_tpu/engine/adjoint.py).

The dense step (engine/step.py) is a function of tensors, so reverse-mode
autograd through a rollout gives the exact discrete adjoint of the solver
(boundary coupling, collision, windkessel ODE) with no extra solver code.
lbm_tpu takes jax.grad through its XLA dense step; neither package has a
kernel on this route, so the port's is torch ops on the case's device.

The clinical target is outlet-termination calibration: choose each RCR
outlet's distal resistance so the computed flow split matches a measured
target (`fit_windkessel`), and the contrast-curve inverse problem: recover
the lattice diffusivity from a washout series (`fit_diffusivity`).

Mechanics
---------
- `make_step_theta(cc)` is make_step_wk with the per-outlet (Rp, C, Rd)
  triples an (n_wk, 3) tensor `theta` (step.windkessel_update takes
  either), so gradients flow through the RCR values into the outlet rho*
  and on through the whole flow field; with theta equal to the static
  values it is make_step_wk bit for bit.
- `rollout` runs chunks of `remat_chunk` steps, each under
  torch.utils.checkpoint (use_reentrant=False): the forward keeps only
  the chunks' input states, and the backward recomputes one chunk at a
  time, so peak memory is ~(n_steps/remat_chunk) states plus one chunk's
  activations (lbm_tpu's two-level jax.checkpoint scan). On CUDA the same
  checkpointing replays CUDA graphs: the forward a graph of one step
  without autograd, the backward a chunk captured with its backward
  (`RolloutGraphs`), so the host launches no kernel one by one; the
  values are the eager route's.
- The optimiser is `Adam`, optax.adam's update in its own operation order
  (optax is a JAX package). The fits descend log Rd and log(tau_g - 1/2)
  (positivity built in) and return the best iterate, not the last: Adam
  at a fixed rate orbits the optimum once the loss is small.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from lbm_tpu_torch.engine.compile import CompiledCase, compile_case, wk_init
from lbm_tpu_torch.engine.graph import StepGraph, graphable
from lbm_tpu_torch.engine.step import (
    has_windkessel,
    initial_f,
    pulled_state_wk,
    step_tail,
    windkessel_fluxes,
)

_F32 = np.float32


def wk_params(cc: CompiledCase) -> np.ndarray:
    """The case's static RCR parameters as the (n_wk, 3) float32 theta
    array, in boundary order (compile.wk_init's)."""
    rows = [bc.windkessel for bc in cc.bcs if bc.windkessel is not None]
    if not rows:
        raise ValueError("case has no windkessel outlets")
    return np.asarray(rows, np.float32)


def make_step_theta(cc: CompiledCase) -> Callable:
    """The dense windkessel step with the RCR parameters as a tensor:
    (f, t, wk, theta) -> (f', wk'), theta (n_wk, 3) rows of (Rp, C, Rd) in
    lattice units. With theta equal to the static per-boundary values it
    is make_step_wk's step bit for bit."""
    if not has_windkessel(cc.bcs):
        raise ValueError("make_step_theta needs windkessel outlets "
                         "(PlaneBC.windkessel)")

    def step(f, t, wk, theta):
        pulled, wk_new = pulled_state_wk(cc, f, t, wk, theta=theta)
        return step_tail(cc, f, pulled)[0], wk_new

    return step


def outlet_fluxes(cc: CompiledCase, f) -> torch.Tensor:
    """(n_wk,) outward volume fluxes through the coupled outlets' consumer
    planes: the footprint, macro convention (with the Guo half-force
    shift) and outward sign the coupling itself reads
    (step.windkessel_fluxes), so a loss built on these matches the Q that
    drives the RCR ODE."""
    return windkessel_fluxes(cc, f)


def flow_split(cc: CompiledCase, f) -> torch.Tensor:
    """Per-outlet flux fractions q_i / sum(q)."""
    q = outlet_fluxes(cc, f)
    return q / torch.sum(q)


def _chunks(n_steps: int, remat_chunk: int) -> int:
    n_outer, rem = divmod(int(n_steps), int(remat_chunk))
    if rem:
        raise ValueError(f"remat_chunk={remat_chunk} must divide "
                         f"n_steps={n_steps}")
    return n_outer


def _run_chunk(fn, *args):
    """fn(*args) under torch.utils.checkpoint when autograd records (its
    activations recomputed in the backward), else directly."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(a) and a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def rollout(cc: CompiledCase, theta, n_steps: int, f0=None, wk0=None,
            remat_chunk: int = 25, graph=None, graphs=None):
    """Differentiable n_steps rollout from step 0 -> (f_final, wk_final).

    theta: (n_wk, 3) RCR parameters (a tensor that may require grad, or an
    array). remat_chunk: the checkpointed block length (must divide
    n_steps); reverse-mode peak memory ~ n_steps/remat_chunk states + one
    chunk's activations. graph: on CUDA (a case without 'series'
    boundaries) the steps replay CUDA graphs unless False (the same values
    as the eager route). graphs: a RolloutGraphs(cc) to capture into and
    reuse across calls (None: captured for this call)."""
    n_outer = _chunks(n_steps, remat_chunk)
    theta = torch.as_tensor(theta, dtype=torch.float32).to(cc.device)
    f = initial_f(cc) if f0 is None else f0
    wk = (torch.from_numpy(wk_init(cc.bcs)).to(cc.device) if wk0 is None
          else wk0)
    if graphable(cc, graph):
        if graphs is None:
            graphs = RolloutGraphs(cc)
        elif graphs.cc is not cc:
            raise ValueError("graphs= holds another case's graphs")
        return graphs.rollout(f, wk, theta, n_outer, remat_chunk)
    step = make_step_theta(cc)

    def chunk(f, wk, theta, t0: int):
        for i in range(remat_chunk):
            f, wk = step(f, t0 + i, wk, theta)
        return f, wk

    for k in range(n_outer):
        f, wk = _run_chunk(chunk, f, wk, theta, k * remat_chunk)
    return f, wk


class _ChunkReplay(torch.autograd.Function):
    """One checkpointed chunk of the graphed route: the forward replays the
    no-grad step graph (keeping only the chunk's inputs), the backward
    replays the chunk's graphed forward and backward from them."""

    @staticmethod
    def forward(ctx, chunks, n, f, wk, theta):
        ctx.chunks, ctx.n = chunks, n
        ctx.save_for_backward(f, wk, theta)
        return chunks.step.run((f, wk, theta), n)[:2]

    @staticmethod
    def backward(ctx, g_f, g_wk):
        ins = tuple(t.detach().requires_grad_(True)
                    for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ctx.chunks.chunk(ctx.n)(*ins)
        grads = torch.autograd.grad(out, ins, (g_f, g_wk))
        # the graph's gradients live in its pool, which the next chunk's
        # replay writes over: hand autograd copies
        return (None, None) + tuple(g.clone() for g in grads)


class RolloutGraphs:
    """The CUDA graphs of one compiled case's rollout: a step without
    autograd (engine/graph.StepGraph over (f, wk, theta)) and, per chunk
    length, a chunk captured with its backward (torch.cuda.
    make_graphed_callables), each captured at its first use. The dense step
    is some thousand small kernels and its backward twice that; replayed,
    the host launches none of them one by one. The step count is not an
    input (graphable excludes 'series' boundaries, the only boundaries that
    read it). Their memory is freed with the object."""

    def __init__(self, cc: CompiledCase):
        self.cc = cc
        self.step_fn = make_step_theta(cc)
        self.step = None
        self.chunks = {}

    def chunk(self, n: int):
        return self.chunks[n]

    def _build(self, f, wk, theta, n: int):
        if self.step is None:
            self.step = StepGraph(
                lambda f, wk, th: (*self.step_fn(f, 0, wk, th), th),
                (f, wk, theta))
        if n not in self.chunks and torch.is_grad_enabled():
            def chunk(f, wk, theta):
                for _ in range(n):
                    f, wk = self.step_fn(f, 0, wk, theta)
                return f, wk

            samples = tuple(t.detach().clone().requires_grad_(True)
                            for t in (f, wk, theta))
            # one warm-up pass: the step graph above has run every op
            self.chunks[n] = torch.cuda.make_graphed_callables(
                chunk, samples, num_warmup_iters=1)

    def rollout(self, f, wk, theta, n_outer: int, n: int):
        self._build(f, wk, theta, n)
        if not (torch.is_grad_enabled() and theta.requires_grad):
            f, wk, _ = self.step.run((f, wk, theta), n_outer * n)
            return f, wk
        for _ in range(n_outer):
            f, wk = _ChunkReplay.apply(self, n, f, wk, theta)
        return f, wk



class Adam:
    """optax.adam(lr) (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) on one fp32
    tensor, in optax's operation order: mu = (1 - b1) g + b1 mu, nu = (1 -
    b2) g^2 + b2 nu, mu_hat = mu / (1 - b1^k), nu_hat = nu / (1 - b2^k),
    update = -lr mu_hat / (sqrt(nu_hat) + eps), k the step count. The
    decays' powers are fp32 (torch.pow), as optax's."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = (float(lr), float(b1),
                                              float(b2), float(eps))

    def init(self, x):
        return (torch.zeros_like(x), torch.zeros_like(x), 0)

    def update(self, g, state):
        """(update, state') for the gradient g (x' = x + update)."""
        mu, nu, count = state
        mu = (1 - self.b1) * g + self.b1 * mu
        nu = (1 - self.b2) * (g * g) + self.b2 * nu
        count += 1
        k = torch.tensor(float(count), dtype=torch.float32, device=g.device)
        one = torch.ones((), dtype=torch.float32, device=g.device)
        bc1 = one - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                           device=g.device), k)
        bc2 = one - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                           device=g.device), k)
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        return -self.lr * upd, (mu, nu, count)


def _value_and_grad(loss_fn, x):
    """(loss, aux, d loss / d x) of loss_fn(x) -> (loss, aux)."""
    x = x.detach().requires_grad_(True)
    loss, aux = loss_fn(x)
    (g,) = torch.autograd.grad(loss, x)
    return loss.detach(), aux, g


def fit_windkessel(spec, target_split, n_steps: int = 800, iters: int = 30,
                   lr: float = 0.25, remat_chunk: int = 25,
                   theta0: Optional[np.ndarray] = None,
                   verbose: bool = False, device="cuda"):
    """Calibrate the distal resistances: descend log Rd of every RCR outlet
    until the rollout's flow split matches `target_split` (n_wk,). Rp and C
    stay at their case values. Returns (theta_fitted (n_wk, 3) NumPy
    float32, the best iterate's; history: (loss, split) per iterate). Loss
    = sum((split - target)^2) at the rollout's end."""
    from lbm_tpu_torch.engine.runner import resolve_device

    cc = compile_case(spec, resolve_device(device))
    th0 = wk_params(cc) if theta0 is None else np.asarray(theta0, _F32)
    target = torch.from_numpy(np.asarray(target_split, _F32)).to(cc.device)
    base = torch.from_numpy(np.array(th0)).to(cc.device)

    graphs = RolloutGraphs(cc) if graphable(cc, None) else None

    def loss_fn(log_rd):
        theta = torch.cat([base[:, :2], torch.exp(log_rd)[:, None]], dim=1)
        f, _ = rollout(cc, theta, n_steps, remat_chunk=remat_chunk,
                       graphs=graphs)
        split = flow_split(cc, f)
        return torch.sum((split - target) ** 2), split.detach()

    opt = Adam(lr)
    log_rd = torch.log(torch.from_numpy(np.array(th0[:, 2])).to(cc.device))
    state = opt.init(log_rd)
    history = []
    best = (np.inf, log_rd)
    for it in range(iters):
        loss, split, g = _value_and_grad(loss_fn, log_rd)
        loss = float(loss)
        if loss < best[0]:
            best = (loss, log_rd)
        upd, state = opt.update(g, state)
        log_rd = log_rd + upd
        split = split.cpu().numpy()
        history.append((loss, split))
        if verbose:
            print(f"  iter {it:3d} loss {loss:.3e} split "
                  + " ".join(f"{s:.4f}" for s in split), flush=True)
    theta = np.array(th0)
    theta[:, 2] = np.exp(best[1].cpu().numpy())
    return theta, history


def _tau_constants(tau_g, device):
    """(inv_tau, omega) of a relaxation time: a number rounds them to fp32
    from float64, as compile_scalar does; a tensor computes them in fp32
    tensor ops (differentiable)."""
    if not torch.is_tensor(tau_g):
        return (float(_F32(1.0 / float(tau_g))),
                float(_F32(1.0 - 1.0 / float(tau_g))))
    tau = tau_g.to(device=device, dtype=torch.float32)
    inv = torch.ones((), dtype=torch.float32, device=device) / tau
    return inv, 1.0 - inv


def transport_rollout(st, tau_g, n_steps: int, record, remat_chunk: int = 25,
                      g0=None):
    """Differentiable frozen-field transport rollout with the relaxation
    time as an input: advance a ScalarTransport's state (or g0) n_steps,
    the steps counted from 0 as lbm_tpu's, with tau_g (a number, or a
    0-dim tensor that may require grad) and return the (n_steps,
    len(record)) float64 tensor of the
    recorded boundaries' consumer-plane mean concentrations (the
    ScalarTransport.run record). The instance's own tau_g and state stay
    as they are; its div_fix field, built once from the frozen u, does not
    depend on tau_g. The dense pass runs whatever the instance's backend
    (the kernel route's plain version is the same pass). Same chunked
    checkpoint structure as `rollout`."""
    from lbm_tpu_torch.engine.scalar import plane_means, transport_pass

    if st.mesh is not None:
        raise ValueError("transport_rollout runs an unsharded transport")
    n_outer = _chunks(n_steps, remat_chunk)
    sc = st.sc
    bad = [k for k in record if not 0 <= k < len(sc.bcs)]
    if bad:
        raise ValueError(f"record names absent boundaries: {bad}")
    inv_tau, omega = _tau_constants(tau_g, sc.device)
    rec = [sc.bcs[k] for k in record]   # plane_means' terms, column by column

    def chunk(g, inv_tau, omega, t0: int):
        rows = []
        for i in range(remat_chunk):
            g, c = transport_pass(g, t0 + i, sc.phi, sc.nbr_block, sc.bcs,
                                  omega, inv_tau, sc.comp, sc.source,
                                  sc.fluid, sc.dirichlet)
            rows.append(plane_means(c, rec))
        return g, torch.stack(rows)

    g = st.g if g0 is None else g0
    series = []
    for k in range(n_outer):
        g, ys = _run_chunk(chunk, g, inv_tau, omega, k * remat_chunk)
        series.append(ys)
    return torch.cat(series).reshape(int(n_steps), len(rec))


def fit_diffusivity(st, observed, record, n_steps: Optional[int] = None,
                    iters: int = 40, lr: float = 0.1,
                    D0: Optional[float] = None, remat_chunk: int = 25,
                    verbose: bool = False):
    """Recover the lattice diffusivity from a measured washout series:
    descend log(tau_g - 1/2) (= log 4D) until the rollout's consumer-plane
    series matches `observed` ((n_steps, len(record))). Returns (D_fitted,
    the best iterate's; history: (loss, D) per iterate)."""
    from lbm_tpu_torch.engine.scalar import tau_g_of

    dev = st.sc.device
    observed = torch.as_tensor(np.asarray(observed), dtype=torch.float64
                               ).to(dev)
    if n_steps is None:
        n_steps = int(observed.shape[0])
    x = torch.log(torch.tensor(
        float(_F32(tau_g_of(D0) - 0.5 if D0 is not None
                   else st.tau_g - 0.5)), dtype=torch.float32, device=dev))

    def loss_fn(x):
        series = transport_rollout(st, 0.5 + torch.exp(x), n_steps, record,
                                   remat_chunk=remat_chunk)
        return torch.mean((series - observed) ** 2), None

    opt = Adam(lr)
    state = opt.init(x)
    history = []
    best = (np.inf, x)
    for it in range(iters):
        loss, _, g = _value_and_grad(loss_fn, x)
        loss = float(loss)
        if loss < best[0]:
            best = (loss, x)
        upd, state = opt.update(g, state)
        x = x + upd
        d_it = float(np.exp(float(x))) / 4.0
        history.append((loss, d_it))
        if verbose:
            print(f"  iter {it:3d} loss {loss:.3e} D {d_it:.5f}", flush=True)
    return float(np.exp(float(best[1]))) / 4.0, history


__all__ = ["make_step_theta", "outlet_fluxes", "flow_split", "rollout",
           "fit_windkessel", "wk_params", "transport_rollout",
           "fit_diffusivity", "Adam", "RolloutGraphs"]
