"""Whole-vector quasi-Newton minimizers (counterpart of
``paddle_tpu/incubate/optimizer/functional.py``): ``minimize_bfgs`` and
``minimize_lbfgs``, Nocedal & Wright's Algorithm 6.1 and its two-loop
limited-memory form, each step along the strong-Wolfe search of
``optimizer.lbfgs``. The JAX package calls
``jax.scipy.optimize.minimize``; the port writes both in torch on the
initial position's device (gradients by autograd; the search's scalars
read on the host) and returns the same result tuples.

Convergence (``is_converge``) is the JAX package's: the largest gradient
component under ``tolerance_grad``. The loop also ends, unconverged
unless the gradient test holds, after ``max_iters`` steps, on a step
whose largest component is under ``tolerance_change``, or on a step of
length 0 (the search found no decrease).
"""

from __future__ import annotations

import torch

from ...optimizer.lbfgs import _strong_wolfe

__all__ = ["minimize_bfgs", "minimize_lbfgs"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _prep(initial_position, dtype, line_search_fn,
          initial_inverse_hessian_estimate):
    if line_search_fn != "strong_wolfe":
        raise NotImplementedError(
            f"only line_search_fn='strong_wolfe' is supported "
            f"(got {line_search_fn!r})")
    if initial_inverse_hessian_estimate is not None:
        raise NotImplementedError(
            "initial_inverse_hessian_estimate: the search starts from the "
            "identity, as the JAX package's; precondition by "
            "reparameterizing x instead")
    dt = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    x0 = torch.as_tensor(initial_position)
    return x0.detach().to(dt).reshape(-1).clone()


def _value_and_grad(f, x):
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        fx = f(x)
        (g,) = torch.autograd.grad(fx, x)
    return fx.detach(), g.detach()


def _minimize(f, x, direction, update, max_iters, tolerance_grad,
              tolerance_change, max_ls, t0):
    """The loop both minimizers share: ``direction(g)`` gives the search
    direction, ``update(s, y)`` takes the new curvature pair."""
    fx, g = _value_and_grad(f, x)
    nfev = 1
    converged = float(g.abs().max()) < tolerance_grad
    for _ in range(max_iters):
        if converged:
            break
        p = direction(g)
        gtd = float(torch.dot(g, p))
        if gtd >= 0:                      # not a descent direction
            break
        cache = {}

        def phi(t):
            ft, gt = _value_and_grad(f, x + t * p)
            cache[t] = (ft, gt)
            return float(ft), float(torch.dot(gt, p))

        t, _, evals = _strong_wolfe(phi, t0, float(fx), gtd, max_ls=max_ls)
        nfev += evals
        if t not in cache:
            cache[t] = _value_and_grad(f, x + t * p)
            nfev += 1
        f_new, g_new = cache[t]
        x_new = x + t * p
        step = x_new - x
        update(step, g_new - g)
        x, fx, g = x_new, f_new, g_new
        converged = float(g.abs().max()) < tolerance_grad
        if t == 0 or float(step.abs().max()) < tolerance_change:
            break
    return converged, nfev, x, fx, g


def minimize_bfgs(objective_func, initial_position, max_iters: int = 50,
                  tolerance_grad: float = 1e-7,
                  tolerance_change: float = 1e-9,
                  initial_inverse_hessian_estimate=None,
                  line_search_fn: str = "strong_wolfe",
                  max_line_search_iters: int = 50,
                  initial_step_length: float = 1.0,
                  dtype: str = "float32", name=None):
    """Returns ``(is_converge, num_func_calls, position, objective_value,
    objective_gradient, inverse_hessian_estimate)``; ``objective_func``
    maps a 1-D tensor to a scalar tensor."""
    x = _prep(initial_position, dtype, line_search_fn,
              initial_inverse_hessian_estimate)
    n = x.numel()
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    H = [eye.clone()]

    def direction(g):
        return -(H[0] @ g)

    def update(s, y):
        ys = torch.dot(y, s)
        if float(ys) <= 0:                # keep H positive definite
            return
        rho = 1.0 / ys
        a = eye - rho * torch.outer(s, y)
        H[0] = a @ H[0] @ a.T + rho * torch.outer(s, s)

    ok, nfev, x, fx, g = _minimize(
        objective_func, x, direction, update, max_iters, tolerance_grad,
        tolerance_change, max_line_search_iters, initial_step_length)
    return (torch.tensor(ok), torch.tensor(nfev), x, fx, g, H[0])


def minimize_lbfgs(objective_func, initial_position, history_size: int = 100,
                   max_iters: int = 50, tolerance_grad: float = 1e-7,
                   tolerance_change: float = 1e-9,
                   initial_inverse_hessian_estimate=None,
                   line_search_fn: str = "strong_wolfe",
                   max_line_search_iters: int = 50,
                   initial_step_length: float = 1.0,
                   dtype: str = "float32", name=None):
    """Returns ``(is_converge, num_func_calls, position, objective_value,
    objective_gradient)``; the inverse Hessian is the two-loop recursion
    over the last ``history_size`` (s, y) pairs, scaled by s.y / y.y."""
    x = _prep(initial_position, dtype, line_search_fn,
              initial_inverse_hessian_estimate)
    hist = []

    def direction(g):
        q = -g
        al = []
        for s, y, rho in reversed(hist):
            a = rho * torch.dot(s, q)
            al.append(a)
            q = q - a * y
        if hist:
            s, y, _ = hist[-1]
            q = q * (torch.dot(s, y) / torch.dot(y, y))
        for (s, y, rho), a in zip(hist, reversed(al)):
            q = q + s * (a - rho * torch.dot(y, q))
        return q

    def update(s, y):
        ys = torch.dot(y, s)
        if float(ys) <= 0:
            return
        hist.append((s, y, 1.0 / ys))
        if len(hist) > history_size:
            hist.pop(0)

    ok, nfev, x, fx, g = _minimize(
        objective_func, x, direction, update, max_iters, tolerance_grad,
        tolerance_change, max_line_search_iters, initial_step_length)
    return (torch.tensor(ok), torch.tensor(nfev), x, fx, g)
