"""Device mesh and hybrid topology over ``torch.distributed`` (counterpart
of ``paddle_tpu/parallel/mesh.py``).

The JAX package runs one controller over every device and lets GSPMD
place collectives from sharding annotations. The port runs one process
per rank, as Paddle and torch do: each process holds its own shards and
calls the collectives itself. A :class:`HybridMesh` is a
``torch.distributed.device_mesh.DeviceMesh`` over the JAX axis names and
order (:data:`AXES_ORDER`, or :data:`AXES_ORDER_EP` when ``ep`` > 1,
the ``ep`` axis carved out of ``dp``), rank ``r`` at the row-major
coordinate of ``r`` as JAX places device ``r``. Single axes take the
DeviceMesh's process groups; a set of axes (the data axes, a tensor
group with its replicas) gets one ``new_group`` per slice, made at
:meth:`HybridMesh.build` for the sets the port uses, so that every rank
creates them in the same order.

Bootstrap: :func:`init_parallel_env` reads torchrun's ``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT`` (or
Paddle's ``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``), or takes an
explicit ``init_method``; it defaults to NCCL on the card.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES_ORDER = ("pp", "dp", "fsdp", "sep", "tp")
AXES_ORDER_EP = ("pp", "dp", "ep", "fsdp", "sep", "tp")
# the axes that split the batch (rows over dp, ep and fsdp; the sequence
# over sep): a replicated parameter's gradient is summed over them
BATCH_AXES = ("dp", "ep", "fsdp")
DATA_AXES = BATCH_AXES + ("sep",)

_CURRENT: List["HybridMesh"] = []


class HybridMesh:
    """A named device mesh plus the HybridCommunicateGroup queries.
    ``device_mesh`` is the DeviceMesh (its dims named as ``axes``);
    :meth:`group` gives the process group of any set of axes at this
    rank's coordinate."""

    def __init__(self, device_mesh, axes: Tuple[str, ...],
                 sizes: Dict[str, int], ep_degree: int = 1):
        self.device_mesh = device_mesh
        self.axes = tuple(axes)
        self.shape = dict(sizes)
        self.ep_degree = ep_degree
        self.ranks = np.arange(int(np.prod([sizes[a] for a in axes]))
                               ).reshape([sizes[a] for a in axes])
        self.rank = dist.get_rank()
        self._coord = dict(zip(self.axes, (int(c) for c in np.argwhere(
            self.ranks == self.rank)[0])))
        self._groups: Dict[Tuple[str, ...], Tuple] = {}
        self._subgroups: Dict[Tuple, Tuple] = {}

    # -- construction ----------------------------------------------------------

    @staticmethod
    def build(dp: int = 1, fsdp: int = 1, tp: int = 1, pp: int = 1,
              sep: int = 1, ep: int = 1, devices=None) -> "HybridMesh":
        """The mesh of these degrees over the initialised default process
        group (:func:`init_parallel_env`), whose world size they must
        multiply to. ``ep`` must divide ``dp``: with ``ep`` > 1 the mesh
        has a real ``ep`` axis and ``dp`` shrinks to ``dp // ep``, as in
        JAX. ``devices`` is the DeviceMesh's device type ("cuda" or
        "cpu"); None takes the default group's: "cuda" under NCCL, else
        "cpu"."""
        if not dist.is_initialized():
            raise RuntimeError(
                "HybridMesh.build needs an initialised process group: call "
                "paddle_tpu_torch.distributed.init_parallel_env first")
        sizes = {"pp": pp, "dp": dp, "fsdp": fsdp, "sep": sep, "tp": tp}
        total = int(np.prod(list(sizes.values())))
        world = dist.get_world_size()
        if total != world:
            raise ValueError(f"mesh degrees {sizes} multiply to {total} but "
                             f"the world has {world} ranks")
        if ep != 1 and dp % ep != 0:
            raise ValueError(
                f"ep={ep} must divide dp={dp}: expert parallelism carves an "
                f"expert subgroup out of the data ranks")
        if ep != 1:
            sizes = {"pp": pp, "dp": dp // ep, "ep": ep, "fsdp": fsdp,
                     "sep": sep, "tp": tp}
            axes = AXES_ORDER_EP
        else:
            axes = AXES_ORDER
        if devices is None:
            devices = "cuda" if dist.get_backend() == "nccl" else "cpu"
        from torch.distributed.device_mesh import init_device_mesh
        dm = init_device_mesh(devices, tuple(sizes[a] for a in axes),
                              mesh_dim_names=axes)
        hm = HybridMesh(dm, axes, sizes, ep)
        # every multi-axis group the port uses, made here in one order on
        # every rank (new_group is collective over the world): the data
        # axes with and without ep (expert gradients skip it), the
        # global norm's axes, and the pipeline's first and last stages
        for group_axes in (hm.data_axes, ("dp", "ep", "sep"),
                           ("dp", "ep", "fsdp"), ("dp", "fsdp"),
                           ("dp", "fsdp", "sep"), ("dp", "sep"),
                           ("fsdp", "tp"), ("pp", "ep", "fsdp", "tp"),
                           hm.axes):
            hm.group(group_axes)
        hm.stage_ends_group()
        return hm

    # -- topology queries (HybridCommunicateGroup) ---------------------------

    def axis_size(self, name: str) -> int:
        return self.shape.get(name, 1)

    def coordinate(self, name: str) -> int:
        """This rank's index along axis ``name`` (0 for an absent axis)."""
        return self._coord.get(name, 0)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in DATA_AXES if a in self.shape)

    def get_data_parallel_world_size(self) -> int:
        # the ep axis is carved out of dp, so data ranks span dp x ep x fsdp
        return (self.axis_size("dp") * self.axis_size("ep")
                * self.axis_size("fsdp"))

    def get_model_parallel_world_size(self) -> int:
        return self.axis_size("tp")

    def get_pipe_parallel_world_size(self) -> int:
        return self.axis_size("pp")

    def get_sharding_parallel_world_size(self) -> int:
        return self.axis_size("fsdp")

    def get_sep_parallel_world_size(self) -> int:
        return self.axis_size("sep")

    def get_expert_parallel_world_size(self) -> int:
        return max(self.axis_size("ep"), self.ep_degree)

    @property
    def nproc(self) -> int:
        return int(self.ranks.size)

    # -- groups ----------------------------------------------------------------

    def _slices(self, axes: Sequence[str]) -> np.ndarray:
        """[slices, members]: the world's ranks grouped by their
        coordinates off ``axes``, members in row-major order of
        ``axes``."""
        idx = [self.axes.index(a) for a in axes]
        rest = [i for i in range(len(self.axes)) if i not in idx]
        arr = np.transpose(self.ranks, rest + idx)
        return arr.reshape(-1, int(np.prod([self.ranks.shape[i]
                                            for i in idx] or [1])))

    def group_ranks(self, axes) -> List[int]:
        """The world ranks of this rank's group over ``axes``."""
        for row in self._slices(self._axes(axes)):
            if self.rank in row:
                return [int(r) for r in row]
        raise AssertionError("rank outside its mesh")

    def _axes(self, axes) -> Tuple[str, ...]:
        """``axes`` in mesh order, those of size 1 left out."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axes if a in axes and self.shape[a] > 1)

    def group(self, axes):
        """The process group of ``axes`` (a name or several) at this
        rank's coordinate, or None when it holds this rank alone (every
        collective over it is the identity)."""
        axes = self._axes(axes)
        if axes not in self._groups:
            n = int(np.prod([self.shape[a] for a in axes] or [1]))
            if n == 1:
                self._groups[axes] = (None, [self.rank])
            elif len(axes) == 1:
                self._groups[axes] = (self.device_mesh.get_group(axes[0]),
                                      self.group_ranks(axes))
            else:
                mine = None
                for row in self._slices(axes):
                    g = dist.new_group([int(r) for r in row])
                    if self.rank in row:
                        mine = (g, [int(r) for r in row])
                self._groups[axes] = mine
        return self._groups[axes][0]

    def subgroup(self, axis: str, size: int):
        """The group of this rank's block of ``size`` consecutive ranks
        along ``axis``: the tensor ranks that hold one replicated KV head.
        Made on every rank at the same call (the port's shard_layer is
        SPMD). None when ``size`` is 1."""
        key = (axis, size)
        if key not in self._subgroups:
            n = self.shape[axis]
            if n % size:
                raise ValueError(f"{size} does not divide {axis}={n}")
            mine = None
            if size > 1:
                for row in self._slices((axis,)):
                    for b in range(0, n, size):
                        ranks = [int(r) for r in row[b:b + size]]
                        g = dist.new_group(ranks)
                        if self.rank in ranks:
                            mine = g
            self._subgroups[key] = mine
        return self._subgroups[key]

    def stage_ends_group(self):
        """The group of this rank's first and last ``pp`` stage (the
        ranks that hold a tied embedding), None without a pp axis; the
        pp group itself when it has two stages. Made on every rank at
        :meth:`build`."""
        n = self.axis_size("pp")
        if n < 2:
            return None
        if n == 2:
            return self.group("pp")
        if "stage_ends" not in self._subgroups:
            mine = None
            for row in self._slices(("pp",)):
                ranks = [int(row[0]), int(row[-1])]
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = g
            self._subgroups["stage_ends"] = mine
        return self._subgroups["stage_ends"]

    def group_size(self, axes) -> int:
        axes = self._axes(axes)
        return int(np.prod([self.shape[a] for a in axes] or [1]))

    def group_rank(self, axes) -> int:
        """This rank's index in its group over ``axes`` (row-major)."""
        axes = self._axes(axes)
        r = 0
        for a in axes:
            r = r * self.shape[a] + self.coordinate(a)
        return r

    # -- context ---------------------------------------------------------------

    def __enter__(self):
        _CURRENT.append(self)
        return self

    def __exit__(self, *exc):
        _CURRENT.remove(self)
        return False

    def __repr__(self):
        return f"HybridMesh({self.shape})"


def current_mesh() -> Optional[HybridMesh]:
    """The innermost mesh entered (``with mesh:``, ``fleet.init``), or
    None."""
    return _CURRENT[-1] if _CURRENT else None


def pod_bootstrap_env() -> Optional[dict]:
    """The process group's rendezvous from the environment, or None for
    a single-process job. Sources, first complete set wins (fields are
    never mixed across sources): torchrun's ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` (with ``LOCAL_RANK``),
    then Paddle's ``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ID`` beside
    ``MASTER_ADDR`` / ``MASTER_PORT`` (the JAX package's second source;
    its ``JAX_*`` trio names JAX's coordinator and has no meaning
    here). Returns ``{"init_method", "world_size", "rank",
    "local_rank"}``."""
    env = os.environ
    addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
    if not (addr and port):
        return None
    for world, rank in ((env.get("WORLD_SIZE"), env.get("RANK")),
                        (env.get("PADDLE_TRAINERS_NUM"),
                         env.get("PADDLE_TRAINER_ID"))):
        if world and rank not in (None, ""):
            if int(world) <= 1:
                return None
            return {"init_method": f"tcp://{addr}:{port}",
                    "world_size": int(world), "rank": int(rank),
                    "local_rank": int(env.get("LOCAL_RANK", rank))}
    return None


def local_card(local_rank: int) -> int:
    """The index of the card a rank takes among those it sees: its local
    rank modulo their count, so a rank shown one card (the launcher's
    ``--devices``) takes card 0. Read from the rendezvous alone:
    ``FLAGS_selected_gpus`` and the like, which a Paddle user may have
    exported, choose nothing."""
    return int(local_rank) % max(torch.cuda.device_count(), 1)


def init_parallel_env(dp: int = 1, fsdp: int = 1, tp: int = 1, pp: int = 1,
                      sep: int = 1, ep: int = 1, backend: str = "nccl",
                      init_method: Optional[str] = None,
                      world_size: Optional[int] = None,
                      rank: Optional[int] = None,
                      device: str = "cuda") -> HybridMesh:
    """Bring up the default process group and return the mesh of these
    degrees (not entered: ``with mesh:`` or ``fleet.init`` make it
    current). Counterpart of JAX's ``init_parallel_env``.

    The rendezvous is ``init_method`` with ``world_size`` and ``rank``
    when given (a ``file://`` path or ``tcp://host:port``), else
    :func:`pod_bootstrap_env`, else a group of one on a private
    ``file://`` store beside the process. ``backend`` defaults to NCCL
    and ``device`` to the card :func:`local_card` names; the CPU runs
    ask for ``backend="gloo", device="cpu"``. There is no fallback: a
    backend that fails to start raises. An initialised group is
    reused."""
    if not dist.is_initialized():
        env = pod_bootstrap_env()
        local = 0
        if init_method is None and env is not None:
            init_method, world_size, rank = (env["init_method"],
                                             env["world_size"], env["rank"])
            local = local_card(env["local_rank"])
        elif init_method is None:
            import tempfile
            init_method = "file://" + os.path.join(
                tempfile.mkdtemp(prefix="pt_pg_"), "store")
            world_size, rank = 1, 0
        if world_size is None or rank is None:
            raise ValueError("an explicit init_method needs world_size and "
                             "rank")
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else local)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=int(world_size), rank=int(rank))
    return HybridMesh.build(dp=dp, fsdp=fsdp, tp=tp, pp=pp, sep=sep, ep=ep,
                            devices=torch.device(device).type)


__all__ = ["AXES_ORDER", "AXES_ORDER_EP", "DATA_AXES", "HybridMesh",
           "current_mesh", "pod_bootstrap_env", "local_card",
           "init_parallel_env"]
