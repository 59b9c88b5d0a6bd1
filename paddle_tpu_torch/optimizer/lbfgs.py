"""L-BFGS (counterpart of ``paddle_tpu/optimizer/lbfgs.py``): a
closure-driven optimizer over the whole flattened parameter vector, with
the two-loop recursion over a bounded (s, y) history and an optional
strong-Wolfe line search.

The closure contract is JAX's: ``closure() -> (loss, grads_dict)``
evaluated at the current values of the bound parameters (here the
parameters are written in place before each call). The flat vector, the
history and every axpy stay in fp32 on the parameters' device; the
scalars the search branches on (the loss, the directional derivatives,
the curvature test) are read on the host, as the JAX version reads them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from .optimizer import Optimizer


def _flatten(tensors: Dict[str, torch.Tensor], names) -> torch.Tensor:
    return torch.cat([tensors[n].detach().float().reshape(-1)
                      for n in names])


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    """Minimizer of the cubic through (x1, f1, g1), (x2, f2, g2) — the
    safeguarded interpolation step of the strong-Wolfe search (host
    floats)."""
    if bounds is not None:
        xmin_bound, xmax_bound = bounds
    else:
        xmin_bound, xmax_bound = (x1, x2) if x1 <= x2 else (x2, x1)
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    d2_square = d1 ** 2 - g1 * g2
    if d2_square >= 0:
        d2 = d2_square ** 0.5
        if x1 <= x2:
            min_pos = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
        else:
            min_pos = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
        return min(max(min_pos, xmin_bound), xmax_bound)
    return (xmin_bound + xmax_bound) / 2.0


def _strong_wolfe(phi, t, f0, g0_dot_d, c1=1e-4, c2=0.9, max_ls=25):
    """Scalar strong-Wolfe line search on ``phi(t) -> (f, dphi)`` (host
    floats). Returns ``(t, f_t, n_evals)``."""
    f_prev, g_prev, t_prev = f0, g0_dot_d, 0.0
    f_t, g_t = phi(t)
    evals = 1
    # bracketing phase
    bracket = None
    for _ in range(max_ls):
        if f_t > f0 + c1 * t * g0_dot_d or (evals > 1 and f_t >= f_prev):
            bracket = (t_prev, f_prev, g_prev, t, f_t, g_t)
            break
        if abs(g_t) <= -c2 * g0_dot_d:
            return t, f_t, evals
        if g_t >= 0:
            bracket = (t, f_t, g_t, t_prev, f_prev, g_prev)
            break
        t_next = _cubic_interpolate(t_prev, f_prev, g_prev, t, f_t, g_t,
                                    bounds=(1.01 * t, 10 * t))
        t_prev, f_prev, g_prev = t, f_t, g_t
        t = t_next
        f_t, g_t = phi(t)
        evals += 1
    if bracket is None:
        return t, f_t, evals
    # zoom phase
    lo_t, lo_f, lo_g, hi_t, hi_f, hi_g = bracket
    for _ in range(max_ls - evals):
        t = _cubic_interpolate(lo_t, lo_f, lo_g, hi_t, hi_f, hi_g)
        f_t, g_t = phi(t)
        evals += 1
        if f_t > f0 + c1 * t * g0_dot_d or f_t >= lo_f:
            hi_t, hi_f, hi_g = t, f_t, g_t
        else:
            if abs(g_t) <= -c2 * g0_dot_d:
                return t, f_t, evals
            if g_t * (hi_t - lo_t) >= 0:
                hi_t, hi_f, hi_g = lo_t, lo_f, lo_g
            lo_t, lo_f, lo_g = t, f_t, g_t
        if abs(hi_t - lo_t) < 1e-9:
            break
    return lo_t, lo_f, evals


class LBFGS(Optimizer):
    """``step(closure)`` minimizer. ``closure() -> (loss, grads_dict)`` at
    the bound parameters' current values; ``step`` runs up to
    ``max_iter`` inner iterations and leaves the parameters at the last
    point. ``weight_decay`` and ``grad_clip`` are refused, as in JAX."""

    def __init__(self, learning_rate: float = 1.0, max_iter: int = 20,
                 max_eval: Optional[int] = None,
                 tolerance_grad: float = 1e-7,
                 tolerance_change: float = 1e-9, history_size: int = 100,
                 line_search_fn: Optional[str] = None, parameters=None,
                 weight_decay: float = 0.0, grad_clip=None):
        if weight_decay:
            raise ValueError("LBFGS does not apply weight_decay; fold the "
                             "penalty into the closure's loss instead")
        if grad_clip is not None:
            raise ValueError("LBFGS does not support grad_clip (the line "
                             "search already bounds the step)")
        super().__init__(learning_rate, parameters, 0.0, None,
                         multi_precision=False)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError("line_search_fn must be None or 'strong_wolfe'")
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None \
            else max_iter * 5 // 4
        self.tolerance_grad = tolerance_grad
        self.tolerance_change = tolerance_change
        self.history_size = history_size
        self.line_search_fn = line_search_fn
        self._s: List[torch.Tensor] = []
        self._y: List[torch.Tensor] = []
        self._rho: List[torch.Tensor] = []
        self._n_evals = 0

    def _direction(self, flat_grad: torch.Tensor) -> torch.Tensor:
        """Two-loop recursion over the stored (s, y) curvature pairs."""
        q = -flat_grad
        al = []
        for s, y, rho in zip(reversed(self._s), reversed(self._y),
                             reversed(self._rho)):
            a = rho * torch.dot(s, q)
            al.append(a)
            q = q - a * y
        if self._y:
            gamma = torch.dot(self._s[-1], self._y[-1]) / torch.clamp(
                torch.dot(self._y[-1], self._y[-1]), min=1e-10)
            q = q * gamma
        for (s, y, rho), a in zip(zip(self._s, self._y, self._rho),
                                  reversed(al)):
            b = rho * torch.dot(y, q)
            q = q + s * (a - b)
        return q

    def _push_history(self, s: torch.Tensor, y: torch.Tensor) -> None:
        ys = torch.dot(y, s)
        if float(ys) > 1e-10:
            self._s.append(s)
            self._y.append(y)
            self._rho.append(1.0 / ys)
            if len(self._s) > self.history_size:
                self._s.pop(0)
                self._y.pop(0)
                self._rho.pop(0)

    def history_bytes(self) -> int:
        """Bytes the (s, y, rho) history holds on the device."""
        return sum(t.numel() * t.element_size()
                   for t in self._s + self._y + self._rho)

    @torch.no_grad()
    def _write(self, flat: torch.Tensor, names) -> None:
        off = 0
        for n in names:
            p = self._bound_params[n]
            k = p.numel()
            p.copy_(flat[off:off + k].view(p.shape))
            off += k

    def step(self, closure: Callable):
        """One L-BFGS outer step; returns the last loss (a 0-d fp32
        tensor on the parameters' device)."""
        if not self._bound_params:
            raise ValueError("LBFGS requires bound parameters")
        names = list(self._bound_params)

        def eval_at(flat_x):
            self._write(flat_x, names)
            loss, grads = closure()
            self._n_evals += 1
            return (torch.as_tensor(loss).detach().float(),
                    _flatten(grads, names))

        x = _flatten(self._bound_params, names)
        loss, flat_grad = eval_at(x)
        if float(flat_grad.abs().max()) <= self.tolerance_grad:
            return loss

        lr = self.get_lr()
        n_evals_start = self._n_evals
        for it in range(self.max_iter):
            d = self._direction(flat_grad)
            gtd = torch.dot(flat_grad, d)
            if float(gtd) > -self.tolerance_change:
                break
            t = lr if (self._s or it > 0) else \
                min(1.0, 1.0 / float(flat_grad.abs().sum())) * lr

            if self.line_search_fn == "strong_wolfe":
                cache = {}

                def phi(tt):
                    l, g = eval_at(x + tt * d)
                    cache[tt] = (l, g)
                    return float(l), float(torch.dot(g, d))

                t, _, _ = _strong_wolfe(phi, t, float(loss), float(gtd))
                new_loss, new_grad = cache.get(t) or eval_at(x + t * d)
            else:
                new_loss, new_grad = eval_at(x + t * d)

            x_new = x + t * d
            self._push_history(x_new - x, new_grad - flat_grad)
            delta = float((new_loss - loss).abs())
            x, loss, flat_grad = x_new, new_loss, new_grad
            if float(flat_grad.abs().max()) <= self.tolerance_grad:
                break
            if delta < self.tolerance_change:
                break
            if self._n_evals - n_evals_start >= self.max_eval:
                break

        # leave the parameters at the final point
        self._write(x, names)
        return loss

    def state_dict(self) -> Dict:
        return {"s": list(self._s), "y": list(self._y),
                "rho": list(self._rho), "n_evals": self._n_evals}

    def set_state_dict(self, state: Dict) -> None:
        self._s = list(state.get("s", []))
        self._y = list(state.get("y", []))
        self._rho = list(state.get("rho", []))
        self._n_evals = state.get("n_evals", 0)


__all__ = ["LBFGS"]
