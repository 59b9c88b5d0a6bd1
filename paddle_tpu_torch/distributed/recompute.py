"""Activation recomputation (counterpart of
``paddle_tpu/distributed/recompute.py``).

``jax.checkpoint`` becomes ``torch.utils.checkpoint.checkpoint`` with
the non-reentrant engine: the forward keeps only what the policy names,
and the backward re-runs the function to rebuild the rest. Policies, by
the JAX package's names:

- ``None``, ``"full"``, ``"nothing_saveable"``: keep nothing;
- ``"dots_with_no_batch_dims_saveable"``: keep the outputs of 2-D matrix
  products (``aten.mm``, ``aten.addmm``: the model's projections) and
  recompute the rest, attention included;
- ``"dots_saveable"`` / ``"checkpoint_dots"``: batched products too;
- ``"everything_saveable"``: keep every output;
- a callable: a selective-checkpoint policy ``(ctx, op, *args,
  **kwargs) -> CheckpointPolicy``.

The port's layers draw nothing from a global random stream (dropout is a
counter hash of an explicit seed), so a recomputed forward reproduces
the original bit for bit, as explicit keys make it in JAX. The CUDA
kernels run through ``ctypes`` and are invisible to the dispatch mode
that keeps the products: what it keeps is the tensor ``aten.mm``
returned, and no kernel of the port writes into an input in place, so
the recompute reads back what the forward computed.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

_aten = torch.ops.aten
_MM = frozenset({_aten.mm.default, _aten.addmm.default})
_BATCHED = frozenset({_aten.bmm.default, _aten.baddbmm.default})


def _keep(ops):
    def policy(ctx, op, *args, **kwargs):
        if ops is None or op in ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


_POLICIES = {
    "full": None,
    "nothing_saveable": None,
    "dots_saveable": _keep(_MM | _BATCHED),
    "dots_with_no_batch_dims_saveable": _keep(_MM),
    "checkpoint_dots": _keep(_MM | _BATCHED),
    "everything_saveable": _keep(None),
}


def resolve_policy(policy):
    """A policy name, callable or None → None (keep nothing) or a
    selective-checkpoint policy function."""
    if policy is None or callable(policy):
        return policy
    if policy in _POLICIES:
        return _POLICIES[policy]
    raise ValueError(f"unknown recompute policy {policy!r}; "
                     f"one of {sorted(_POLICIES)}")


def recompute(function: Callable, *args, policy=None,
              use_reentrant: bool = True, preserve_rng_state: bool = True,
              **kwargs):
    """Run ``function(*args, **kwargs)`` under recompute, now (the call
    style of ``paddle.distributed.fleet.recompute``). ``use_reentrant``
    is accepted for parity, as in the JAX package: the port always takes
    the non-reentrant engine, the one that takes a policy."""
    pol = resolve_policy(policy)
    extra = ({} if pol is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, pol)})
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **extra,
                      **kwargs)


def recompute_wrapper(function: Callable, policy=None) -> Callable:
    """Decorator form: ``function`` run under recompute at each call."""
    @functools.wraps(function)
    def wrapped(*args, **kwargs):
        return recompute(function, *args, policy=policy, **kwargs)
    return wrapped


def recompute_sequential(ctx: Optional[dict], functions, *args):
    """Reference: recompute_sequential. The single-input chain
    ``functions`` (a Sequential or any iterable of callables) in
    ``ctx["segments"]`` chunks (1 by default), each chunk recomputed as
    one unit; returns the chain's output."""
    if len(args) != 1:
        raise ValueError("recompute_sequential chains single-input "
                         "functions")
    segments = (ctx or {}).get("segments", 1)
    fns = list(functions)
    x = args[0]
    per = max(1, (len(fns) + segments - 1) // segments)
    for i in range(0, len(fns), per):
        def run_chunk(xx, _chunk=tuple(fns[i:i + per])):
            for f in _chunk:
                xx = f(xx)
            return xx
        x = recompute(run_chunk, x)
    return x


def recompute_hybrid(ctx: Optional[dict], function: Callable, *args,
                     **kwargs):
    """Reference: recompute_hybrid.py (recompute with the hybrid-parallel
    random-state sync). The port's layers draw no global random stream,
    so this is :func:`recompute` under ``ctx["policy"]``."""
    return recompute(function, *args, policy=(ctx or {}).get("policy"),
                     **kwargs)


__all__ = ["recompute", "recompute_wrapper", "resolve_policy",
           "recompute_sequential", "recompute_hybrid"]
