"""The port's LBFGS and the ``incubate.optimizer.functional`` minimizers
against the JAX package's, on the CPU.

LBFGS: the JAX package's own cases (``tests/test_lbfgs.py``: a quadratic,
Rosenbrock under the strong-Wolfe search, a bounded history) on the port,
and on each the closure evaluations equal to JAX's ``LBFGS``'s and the
iterate within 1e-5 of JAX's (both run the same host-side search on fp32
vectors; the dot products' summation order may differ). The minimizers
(``minimize_bfgs``, ``minimize_lbfgs``; JAX's call
``jax.scipy.optimize.minimize``, the port's are its own torch loops):
``is_converge`` equal and the converged positions within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.incubate.optimizer import functional as jfunc
from paddle_tpu.nn import initializer as I
from paddle_tpu.optimizer import LBFGS as JaxLBFGS
from paddle_tpu_torch.incubate.optimizer import functional as tfunc
from paddle_tpu_torch.optimizer import LBFGS
from paddle_tpu_torch.optimizer.lbfgs import _cubic_interpolate, _strong_wolfe

TOL = 1e-5


def _quad(n, seed):
    rs = np.random.RandomState(seed)
    a = rs.randn(n, n)
    A = (a @ a.T + n * np.eye(n)).astype(np.float32)
    b = rs.randn(n).astype(np.float32)
    return A, b


def _quad_loss(x, A, b, lib):
    return 0.5 * x @ A @ x - b @ x


def _rosen(x, lib):
    return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2


class _JaxVec(jnn.Layer):
    def __init__(self, x0):
        super().__init__()
        self.x = self.create_parameter(
            [len(x0)], dtype="float32",
            initializer=I.Assign(np.asarray(x0, np.float32)))


def _jax_run(x0, f, steps, **kw):
    m = _JaxVec(x0)
    opt = JaxLBFGS(parameters=m, **kw)

    def closure():
        pv = {n: p.value for n, p in m.named_parameters()}
        return jax.value_and_grad(lambda p: f(p["x"]))(pv)

    losses = [float(opt.step(closure)) for _ in range(steps)]
    return np.asarray(m.x), losses, opt


def _torch_run(x0, f, steps, **kw):
    x = torch.tensor(np.asarray(x0, np.float32))
    opt = LBFGS(parameters={"x": x}, **kw)

    def closure():
        v = x.detach().requires_grad_(True)
        loss = f(v)
        (g,) = torch.autograd.grad(loss, v)
        return loss.detach(), {"x": g}

    losses = [float(opt.step(closure)) for _ in range(steps)]
    return x.numpy(), losses, opt


# the cases of tests/test_lbfgs.py: (x0, objective, steps, LBFGS args).
# The quadratics stop before fp32's resolution of their objective: there
# the two frameworks' summation orders decide the tolerance tests and the
# search's comparisons differently (at JAX's max_iter=30 the iterates
# still agree within 1e-5, the counts by one evaluation;
# test_lbfgs_reaches_the_minima_of_the_jax_cases runs those settings).
CASES = {
    "quadratic": (np.zeros(6), "quad6", 1, dict(learning_rate=1.0,
                                                  max_iter=6)),
    "rosenbrock-strong-wolfe": (np.full(2, -1.0), "rosen", 4,
                                dict(learning_rate=1.0, max_iter=60,
                                     line_search_fn="strong_wolfe")),
    "bounded-history": (np.zeros(4), "quad4", 1,
                        dict(learning_rate=1.0, max_iter=50,
                             history_size=3)),
    "quadratic-strong-wolfe": (np.zeros(6), "quad6", 1,
                               dict(learning_rate=1.0, max_iter=3,
                                    history_size=4,
                                    line_search_fn="strong_wolfe")),
}


def _objectives(lib):
    A6, b6 = _quad(6, 0)
    A4, b4 = _quad(4, 1)
    t = (lambda a: jnp.asarray(a)) if lib is jnp else torch.tensor
    return {"quad6": lambda x: _quad_loss(x, t(A6), t(b6), lib),
            "quad4": lambda x: _quad_loss(x, t(A4), t(b4), lib),
            "rosen": lambda x: _rosen(x, lib)}


@pytest.mark.parametrize("case", list(CASES))
def test_lbfgs_matches_jax(case):
    """The iterate within 1e-5 of JAX's, the same closure evaluations and
    history length, and the loss of every outer step within 1e-5."""
    x0, obj, steps, kw = CASES[case]
    jx, jl, jopt = _jax_run(x0, _objectives(jnp)[obj], steps, **kw)
    tx, tl, topt = _torch_run(x0, _objectives(torch)[obj], steps, **kw)
    np.testing.assert_allclose(tx, jx, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert topt._n_evals == jopt._n_evals
    assert len(topt._s) == len(jopt._s)
    assert topt.history_bytes() == sum(
        4 * (s.size + y.size + 1)
        for s, y in zip(jopt._s, jopt._y))


def test_lbfgs_reaches_the_minima_of_the_jax_cases():
    """As ``tests/test_lbfgs.py`` holds the JAX LBFGS: the quadratic's
    solution within 1e-4, Rosenbrock's (1, 1) within 1e-2 with a loss
    under 1e-5, and a history of at most 3 pairs with its state dict."""
    A, b = _quad(6, 0)
    x, _, _ = _torch_run(np.zeros(6), _objectives(torch)["quad6"], 1,
                         learning_rate=1.0, max_iter=30)
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-4,
                               atol=1e-4)
    x, losses, _ = _torch_run(np.full(2, -1.0), _objectives(torch)["rosen"],
                              4, learning_rate=1.0, max_iter=60,
                              line_search_fn="strong_wolfe")
    assert losses[-1] < 1e-5
    np.testing.assert_allclose(x, [1.0, 1.0], rtol=1e-2, atol=1e-2)
    _, _, opt = _torch_run(np.zeros(4), _objectives(torch)["quad4"], 1,
                           learning_rate=1.0, max_iter=50, history_size=3)
    assert 0 < len(opt._s) <= 3
    sd = opt.state_dict()
    assert {"s", "y", "rho", "n_evals"} <= set(sd)
    fresh = LBFGS(parameters={"x": torch.zeros(4)})
    fresh.set_state_dict(sd)
    assert fresh._n_evals == opt._n_evals and len(fresh._s) == len(opt._s)


def test_lbfgs_refuses_what_jax_refuses():
    x = torch.zeros(3)
    with pytest.raises(ValueError, match="weight_decay"):
        LBFGS(parameters={"x": x}, weight_decay=0.1)
    with pytest.raises(ValueError, match="grad_clip"):
        LBFGS(parameters={"x": x}, grad_clip=object())
    with pytest.raises(ValueError, match="line_search_fn"):
        LBFGS(parameters={"x": x}, line_search_fn="backtracking")
    with pytest.raises(ValueError, match="bound parameters"):
        LBFGS().step(lambda: None)


def test_line_search_pieces_match_jax():
    """The host-side search is JAX's: the cubic step and the strong-Wolfe
    result on a 1-D quadratic and a quartic are the same floats."""
    from paddle_tpu.optimizer import lbfgs as jl
    for args in ((0.0, 1.0, -2.0, 1.0, 0.5, 1.0), (2.0, 0.3, 0.5, 0.5, 0.2,
                                                   -0.4)):
        assert _cubic_interpolate(*args) == jl._cubic_interpolate(*args)
        assert _cubic_interpolate(*args, bounds=(0.1, 0.7)) == \
            jl._cubic_interpolate(*args, bounds=(0.1, 0.7))
    for phi in (lambda t: ((t - 0.7) ** 2, 2 * (t - 0.7)),
                lambda t: ((t - 3.0) ** 4 - t, 4 * (t - 3.0) ** 3 - 1)):
        f0, g0 = phi(0.0)
        assert _strong_wolfe(phi, 1.0, f0, g0) == \
            jl._strong_wolfe(phi, 1.0, f0, g0)


# -- the functional minimizers ------------------------------------------------

def _minimizer_problems():
    target = np.asarray([1.0, -2.0, 0.5], np.float32)
    w = np.asarray([1.0, 4.0, 0.5], np.float32)
    A, b = _quad(6, 0)
    return {
        "separable": (lambda x, t: ((x - t(target)) ** 2).sum(),
                      np.zeros(3, np.float32), target),
        "scaled": (lambda x, t: (t(w) * (x - t(target)) ** 2).sum(),
                   np.ones(3, np.float32), target),
        "coupled": (lambda x, t: 0.5 * x @ t(A) @ x - t(b) @ x,
                    np.zeros(6, np.float32), np.linalg.solve(A, b)),
    }


@pytest.mark.parametrize("method", ["bfgs", "lbfgs"])
@pytest.mark.parametrize("problem", list(_minimizer_problems()))
def test_minimizers_match_jax(method, problem):
    """``is_converge`` equal to JAX's and the converged position within
    1e-5 of it (and within 1e-4 of the exact solution: the coupled
    quadratic ends at fp32's resolution of its objective, where both
    report no convergence); the result tuple has the reference's
    fields, the BFGS one its inverse-Hessian estimate."""
    f, x0, exact = _minimizer_problems()[problem]
    jf = getattr(jfunc, f"minimize_{method}")
    tf = getattr(tfunc, f"minimize_{method}")
    kw = dict(max_iters=200)
    want = jf(lambda x: f(x, jnp.asarray), jnp.asarray(x0), **kw)
    got = tf(lambda x: f(x, torch.tensor), torch.tensor(x0), **kw)
    assert len(got) == len(want) == (6 if method == "bfgs" else 5)
    assert bool(got[0]) == bool(want[0])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[2].numpy(), exact, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=TOL,
                               atol=TOL)
    assert int(got[1]) > 0
    if method == "bfgs":
        assert tuple(got[5].shape) == (len(x0), len(x0))


def test_minimizers_refuse_what_jax_refuses():
    for fn in (tfunc.minimize_bfgs, tfunc.minimize_lbfgs):
        with pytest.raises(NotImplementedError, match="strong_wolfe"):
            fn(lambda x: (x ** 2).sum(), torch.zeros(2),
               line_search_fn="hager_zhang")
        with pytest.raises(NotImplementedError, match="inverse_hessian"):
            fn(lambda x: (x ** 2).sum(), torch.zeros(2),
               initial_inverse_hessian_estimate=torch.eye(2))
