"""The rest of the ``paddle.distributed`` surface (counterpart of
``paddle_tpu/distributed/compat.py``): ProcessMesh and DistAttr, the
semi-auto ``Strategy`` / ``DistModel`` / ``to_static``, the process-group
bookkeeping, point-to-point and object collectives, the gloo helpers,
``spawn``, ``split`` and the parameter-server dataset shims.

Reference: python/paddle/distributed/{__init__.py,parallel.py,
collective.py,communication/,auto_parallel/api.py,spawn.py}. The port
runs one process a rank over ``torch.distributed``: a ProcessMesh
becomes a ``HybridMesh`` over the process group, the collectives are
``torch.distributed``'s (object collectives included), and
``DistModel`` trains eagerly through the ``Trainer`` (there is no
program to compile).
"""

from __future__ import annotations

import inspect
import os
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.api import (Placement, Replicate, Shard, mesh_plan_of,
                            shard_layer, shard_tensor)
from ..parallel.mesh import HybridMesh, current_mesh
from .communication import Group, _pg


# -- mesh and dist-attr objects (reference: auto_parallel/process_mesh.py,
#    phi TensorDistAttr) ------------------------------------------------------

class ProcessMesh:
    """An N-D logical process topology (reference:
    auto_parallel/process_mesh.py ProcessMesh). :meth:`hybrid_mesh`
    builds the port's mesh of it over the process group: its dimension
    names must be the mesh's axes (dp, fsdp, tp, pp, sep, ep) and its
    processes the world's ranks in order."""

    def __init__(self, mesh, dim_names: Optional[Sequence[str]] = None,
                 process_ids=None):
        arr = np.asarray(mesh)
        self._shape = list(arr.shape)
        self._process_ids = ([int(i) for i in arr.reshape(-1)]
                             if process_ids is None else list(process_ids))
        self._dim_names = (list(dim_names) if dim_names is not None
                           else [f"d{i}" for i in range(arr.ndim)])

    @property
    def shape(self):
        return self._shape

    @property
    def process_ids(self):
        return self._process_ids

    @property
    def dim_names(self):
        return self._dim_names

    @property
    def ndim(self):
        return len(self._shape)

    def hybrid_mesh(self, devices=None) -> HybridMesh:
        """The port's ``HybridMesh`` of this topology (collective: every
        rank calls it)."""
        if self._process_ids != list(range(len(self._process_ids))):
            raise ValueError(f"ProcessMesh over processes "
                             f"{self._process_ids}: the port's mesh takes "
                             f"the world's ranks in order")
        return HybridMesh.build(devices=devices,
                                **dict(zip(self._dim_names, self._shape)))

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._shape == other._shape
                and self._process_ids == other._process_ids)

    def __repr__(self):
        return (f"ProcessMesh(shape={self._shape}, "
                f"dim_names={self._dim_names})")


class ReduceType:
    """Partial reduce kinds (reference: placement_types.h ReduceType)."""
    kRedSum = "sum"
    kRedMax = "max"
    kRedMin = "min"
    kRedProd = "prod"
    kRedAvg = "avg"
    kRedAny = "any"
    kRedAll = "all"


class DistAttr:
    """A tensor's distributed attributes: a mesh and, per tensor
    dimension, the mesh dimension that splits it or None (reference:
    phi TensorDistAttr as paddle.distributed.DistAttr)."""

    def __init__(self, mesh: ProcessMesh, sharding_specs: Sequence):
        self.process_mesh = mesh
        self.sharding_specs = list(sharding_specs)

    def placements(self) -> List[Placement]:
        """One placement a mesh dimension: Shard(tensor dim) or
        Replicate()."""
        out = []
        for axis_name in self.process_mesh.dim_names:
            if axis_name in self.sharding_specs:
                out.append(Shard(self.sharding_specs.index(axis_name)))
            else:
                out.append(Replicate())
        return out

    def __repr__(self):
        return (f"DistAttr(mesh={self.process_mesh}, "
                f"specs={self.sharding_specs})")


def _hybrid(mesh):
    return mesh.hybrid_mesh() if isinstance(mesh, ProcessMesh) else mesh


def dtensor_from_fn(fn: Callable, mesh, placements: Sequence[Placement],
                    *args, **kwargs):
    """Build a tensor with ``fn`` then place it (reference:
    auto_parallel/api.py dtensor_from_fn:248)."""
    return shard_tensor(fn(*args, **kwargs), mesh=_hybrid(mesh),
                        placements=placements)


def unshard_dtensor(x):
    """A sharded tensor gathered whole (reference: auto_parallel/api.py
    unshard_dtensor); a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def shard_optimizer(optimizer, shard_fn=None):
    """Shard the optimizer state like its parameters (reference:
    auto_parallel/api.py shard_optimizer:710). The port's optimizer
    makes its state from the local shards it updates (``MeshPlan``), so
    it already is; ``shard_fn(name, tensor)`` may replace each master
    and slot."""
    state = getattr(optimizer, "_state", None)
    if shard_fn is not None and state is not None:
        state["master"] = {k: shard_fn(k, v)
                           for k, v in state["master"].items()}
        state["slots"] = {k: {sk: shard_fn(k, sv) for sk, sv in s.items()}
                          for k, s in state["slots"].items()}
    return optimizer


# -- semi-auto: Strategy / DistModel / to_static (reference:
#    auto_parallel/api.py Strategy:775 DistModel:963 to_static:1332) --------

class Strategy:
    """Auto-parallel strategy knobs (reference auto_parallel Strategy),
    grouped as the reference's sub-configs."""

    class _Cfg:
        def __init__(self, **kw):
            self.__dict__.update(kw)

    def __init__(self, config=None):
        config = config or {}
        self.sharding = self._Cfg(enable=False, degree=8, stage=1)
        self.amp = self._Cfg(enable=False, dtype="bfloat16", level="O1")
        self.recompute = self._Cfg(enable=False)
        self.pipeline = self._Cfg(enable=False, schedule_mode="1F1B",
                                  micro_batch_size=1, accumulate_steps=1)
        self.fused_passes = self._Cfg(enable=False, fused_passes_list=[])
        self.gradient_merge = self._Cfg(enable=False, k_steps=1)
        for k, v in config.items():
            cur = getattr(self, k, None)
            if isinstance(v, dict) and isinstance(cur, Strategy._Cfg):
                unknown = set(v) - set(cur.__dict__)
                if unknown:
                    raise ValueError(
                        f"Strategy config '{k}' has unknown keys "
                        f"{sorted(unknown)}; valid: "
                        f"{sorted(cur.__dict__)}")
                cur.__dict__.update(v)
            else:
                setattr(self, k, v)


def _trainer(network, optimizer, loss_fn, keys):
    """The Trainer of a DistModel: the network's own loss (a forward
    that takes the labels), or ``loss_fn(network(*inputs), label)`` over
    the positional arguments under ``keys``."""
    from ..trainer import Trainer

    class _DistTrainer(Trainer):
        def _loss(self, batch):
            if loss_fn is None:
                return super()._loss(batch)
            args = [batch[k] for k in keys]
            return loss_fn(self.model(*args[:-1]), args[-1])
    return _DistTrainer(network, optimizer)


class DistModel:
    """The train / eval / predict facade ``to_static`` returns (reference:
    auto_parallel/api.py DistModel:963). On an entered mesh the network
    is sharded over it (``shard_layer``). ``__call__(*args)`` runs one
    step in the current mode: "train" one Trainer step (forward,
    backward, the mesh's gradient sums, the optimizer's update) and its
    loss; "eval" the loss without a gradient; "predict" the network's
    output. The loss is ``loss(network(*args[:-1]), args[-1])``, or,
    with no ``loss``, the network's own (a forward that takes the
    labels, as the Llama's: ``args`` are its leading positional
    arguments). ``strategy`` is kept and not read, as in JAX."""

    def __init__(self, layer, loader=None, loss=None, optimizer=None,
                 strategy: Optional[Strategy] = None):
        self.network = layer
        self._loader = loader
        self._loss = loss
        self._optimizer = optimizer
        self._strategy = strategy or Strategy()
        self._mode = "train" if optimizer is not None else "eval"
        self._trainer = None
        hm = current_mesh()
        if hm is not None and mesh_plan_of(layer) is None:
            shard_layer(layer, hm)

    def train(self):
        self._mode = "train"
        self.network.train()

    def eval(self):
        self._mode = "eval"
        self.network.eval()

    def predict(self):
        self._mode = "predict"
        self.network.eval()

    def dist_main_program(self, mode=None):  # API-parity introspection
        return None

    def _keys(self, n: int) -> List[str]:
        if self._loss is not None:
            return [f"a{i}" for i in range(n)]
        names = [p.name for p in inspect.signature(
            self.network.forward).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
        return names[:n]

    def __call__(self, *args):
        if self._mode == "predict":
            with torch.no_grad():
                return self.network(*args)
        keys = self._keys(len(args))
        if self._mode == "train" and self._optimizer is not None:
            if self._trainer is None:
                self._trainer = _trainer(self.network, self._optimizer,
                                         self._loss, keys)
            return self._trainer.train_step(dict(zip(keys, args)))
        with torch.no_grad():
            if self._loss is None:
                return self.network(*args)
            return self._loss(self.network(*args[:-1]), args[-1])


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None):
    """reference: auto_parallel/api.py to_static:1332: a DistModel
    running the sharded steps."""
    return DistModel(layer, loader=loader, loss=loss, optimizer=optimizer,
                     strategy=strategy)


# -- the process group (reference: distributed/parallel.py) -----------------

class ParallelEnv:
    """Rank information from the launcher's environment (reference:
    parallel.py ParallelEnv:642), or from the process group."""

    def __init__(self):
        env = os.environ
        up = dist.is_initialized()
        self.rank = int(env.get("PADDLE_TRAINER_ID",
                                dist.get_rank() if up else 0))
        self.world_size = int(env.get("PADDLE_TRAINERS_NUM",
                                      dist.get_world_size() if up else 1))
        # Paddle's form: the first of a comma-separated list
        self.device_id = int(env.get("FLAGS_selected_gpus", "0").split(
            ",")[0])
        self._local_rank = int(env.get("PADDLE_LOCAL_RANK",
                                       env.get("LOCAL_RANK", self.rank)))
        self.current_endpoint = env.get("PADDLE_CURRENT_ENDPOINT", "")
        self.trainer_endpoints = env.get("PADDLE_TRAINER_ENDPOINTS",
                                         "").split(",")

    @property
    def nranks(self):
        return self.world_size

    @property
    def local_rank(self):
        return self._local_rank


class ParallelMode:
    """reference: parallel.py ParallelMode."""
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


def is_available() -> bool:
    return dist.is_available()


def is_initialized() -> bool:
    return dist.is_initialized()


def destroy_process_group(group=None) -> None:
    """Leave every entered mesh and tear the default process group
    down."""
    from ..parallel import mesh as mesh_mod
    while mesh_mod._CURRENT:
        mesh_mod._CURRENT[-1].__exit__(None, None, None)
    if dist.is_initialized():
        dist.destroy_process_group()


def get_backend(group=None) -> str:
    """"NCCL" or "GLOO"."""
    pg = _pg(group)[0] if group is not None else None
    return str(dist.get_backend(pg)).upper()


def get_group(id: int = 0) -> Group:
    """The group of every axis of the current mesh."""
    hm = current_mesh()
    if hm is None:
        raise RuntimeError("init_parallel_env() has not been called")
    return Group(tuple(hm.axes), hm)


def wait(tensor, group=None, use_calc_stream: bool = True):
    """Block the host until ``tensor``'s producers on its card are
    done."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


# -- point to point (reference: distributed/communication/{send,recv}.py) ---

def send(tensor, dst: int = 0, group=None, sync_op: bool = True):
    """Send ``tensor`` to group rank ``dst``; a task to ``wait()`` on when
    not ``sync_op``."""
    pg, _, _, ranks = _pg(group)
    if sync_op:
        dist.send(tensor, ranks[dst], group=pg)
        return None
    return dist.isend(tensor, ranks[dst], group=pg)


def recv(tensor, src: int = 0, group=None, sync_op: bool = True):
    """Receive into ``tensor`` from group rank ``src``; a task when not
    ``sync_op``."""
    pg, _, _, ranks = _pg(group)
    if sync_op:
        dist.recv(tensor, ranks[src], group=pg)
        return tensor
    return dist.irecv(tensor, ranks[src], group=pg)


def isend(tensor, dst: int = 0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src: int = 0, group=None):
    return recv(tensor, src, group, sync_op=False)


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op: bool = True):
    """Single-tensor all-to-all (reference: communication/all_to_all.py
    alltoall_single): dim 0 split over the group's ranks, evenly or by
    ``in_split_sizes`` / ``out_split_sizes``. Returns the output (the
    task as well when not ``sync_op``)."""
    pg, n, _, _ = _pg(group)
    if out_tensor is None:
        rows = (sum(out_split_sizes) if out_split_sizes
                else in_tensor.shape[0])
        out_tensor = in_tensor.new_empty((rows,) + tuple(in_tensor.shape[1:]))
    if n == 1:
        out_tensor.copy_(in_tensor)
        return out_tensor if sync_op else (out_tensor, None)
    work = dist.all_to_all_single(
        out_tensor, in_tensor.contiguous(),
        output_split_sizes=list(out_split_sizes or []) or None,
        input_split_sizes=list(in_split_sizes or []) or None, group=pg,
        async_op=not sync_op)
    return out_tensor if sync_op else (out_tensor, work)


# -- object collectives (reference: communication/{all_gather,broadcast,
#    scatter}.py *_object) -----------------------------------------------------

def _obj_group(group):
    """(process group, size, my index, ranks); a world of one when no
    process group is up."""
    if not dist.is_initialized():
        return None, 1, 0, [0]
    return _pg(group)


def all_gather_object(object_list: list, obj, group=None) -> None:
    """Every rank's picklable ``obj``, in group order, appended to
    ``object_list``."""
    pg, n, _, _ = _obj_group(group)
    if n == 1:
        object_list.append(obj)
        return
    out = [None] * n
    dist.all_gather_object(out, obj, group=pg)
    object_list.extend(out)


def broadcast_object_list(object_list: list, src: int = 0,
                          group=None) -> None:
    """Group rank ``src``'s picklable objects into every rank's list, in
    place."""
    pg, n, _, ranks = _obj_group(group)
    if n > 1:
        dist.broadcast_object_list(object_list, src=ranks[src], group=pg)


def scatter_object_list(out_object_list: list, in_object_list=None,
                        src: int = 0, group=None) -> None:
    """One object a rank from group rank ``src``'s list: rank i's
    ``out_object_list`` becomes [in_object_list[i]]."""
    pg, n, me, ranks = _obj_group(group)
    if n == 1:
        out_object_list[:] = [in_object_list[0]]
        return
    out = [None]
    dist.scatter_object_list(out, in_object_list if me == src else None,
                             src=ranks[src], group=pg)
    out_object_list[:] = out


# -- gloo helpers (reference: parallel.py gloo_init_parallel_env) ---------

_GLOO: List[Any] = [None]


def gloo_init_parallel_env(rank_id: int, rank_num: int,
                           server_endpoint: str) -> None:
    """A gloo group for CPU barriers: the default process group over
    ``tcp://server_endpoint`` when none is up, else a gloo group beside
    it (collective: every rank calls it)."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{server_endpoint}",
                                world_size=int(rank_num), rank=int(rank_id))
    elif dist.get_backend() != "gloo":
        _GLOO[0] = dist.new_group(backend="gloo")


def gloo_barrier() -> None:
    dist.barrier(group=_GLOO[0])


def gloo_release() -> None:
    if _GLOO[0] is not None:
        dist.destroy_process_group(_GLOO[0])
        _GLOO[0] = None


# -- spawn (reference: distributed/spawn.py) -------------------------------

def spawn(func: Callable, args=(), nprocs: int = -1, join: bool = True,
          daemon: bool = False, **options):
    """Start ``nprocs`` processes running ``func(*args)`` (reference:
    distributed/spawn.py), by the ``spawn`` start method (never ``fork``:
    CUDA may be initialised). Each gets a rank's environment
    (``RANK`` / ``WORLD_SIZE`` / ``MASTER_*`` and Paddle's), so
    ``init_parallel_env`` joins them in one group; ``nprocs`` -1 is one a
    visible card (or 1). With ``join`` it waits and raises on a non-zero
    exit; returns the processes."""
    import multiprocessing as mp
    from .launch.main import _free_port
    if nprocs <= 0:
        nprocs = max(torch.cuda.device_count(), 1)
    ctx = mp.get_context("spawn")
    port = str(_free_port())
    procs = []
    for rank in range(nprocs):
        env = {"PADDLE_TRAINER_ID": str(rank),
               "PADDLE_TRAINERS_NUM": str(nprocs),
               "RANK": str(rank), "WORLD_SIZE": str(nprocs),
               "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": port}
        p = ctx.Process(target=_spawn_entry, args=(func, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
        bad = [p.exitcode for p in procs if p.exitcode]
        if bad:
            raise RuntimeError(f"spawn: worker exit codes {bad}")
    return procs


def _spawn_entry(func, args, env):
    os.environ.update(env)
    func(*args)


# -- split (reference: distributed/collective.py split) -----------------------

def split(x, size, operation: str, axis: int = 0, num_partitions: int = 1,
          gather_out: bool = True, weight_attr=None, bias_attr=None,
          name=None):
    """Build and run a row- or column-parallel linear or a vocab-parallel
    embedding over the current mesh's tp axis (reference: collective.py
    split); returns the output. The layer is made on ``x``'s device
    (float weights in ``x``'s dtype)."""
    from ..parallel import mp_layers
    in_sz, out_sz = size
    if operation == "linear":
        kw = dict(device=x.device, dtype=x.dtype, weight_attr=weight_attr)
        layer = (mp_layers.RowParallelLinear(in_sz, out_sz,
                                             input_is_parallel=False, **kw)
                 if axis == 0 else
                 mp_layers.ColumnParallelLinear(in_sz, out_sz,
                                                gather_output=gather_out,
                                                **kw))
    elif operation == "embedding":
        layer = mp_layers.VocabParallelEmbedding(in_sz, out_sz,
                                                 device=x.device)
    else:
        raise ValueError(f"split: unknown operation {operation!r}")
    return layer(x)


# -- parameter-server dataset shims (reference: base/dataset.py
#    InMemoryDataset / QueueDataset; fleet entry configs). The parameter
#    server runtime is not ported; these keep recommendation pipelines
#    importable with the in-memory behaviours that need no server. -----------

class InMemoryDataset:
    """A host-memory sample store with the reference's surface
    (load_into_memory / local_shuffle / get_memory_data_size)."""

    def __init__(self):
        self._files: List[str] = []
        self._samples: List[Any] = []
        self._parse_fn = None
        self._batch_size = 1
        self._thread_num = 1
        self._use_vars = []

    def init(self, batch_size=1, thread_num=1, use_var=None, pipe_command=None,
             input_type=0, fs_name="", fs_ugi="", download_cmd="cat",
             **kwargs):
        self._batch_size = batch_size
        self._thread_num = thread_num
        self._use_vars = use_var or []

    def set_batch_size(self, b):
        self._batch_size = b

    def set_thread(self, t):
        self._thread_num = t

    def set_use_var(self, v):
        self._use_vars = v

    def set_parse_ins_id(self, flag):
        return None

    def set_pipe_command(self, cmd):
        return None

    def set_filelist(self, files: Sequence[str]):
        self._files = list(files)

    def load_into_memory(self):
        self._samples = []
        for path in self._files:
            with open(path, "r") as f:
                for line in f:
                    line = line.rstrip("\n")
                    self._samples.append(
                        self._parse_fn(line) if self._parse_fn else line)

    def local_shuffle(self):
        """Shuffle in place, seeded from torch's global generator."""
        seed = int(torch.randint(0, 2**31 - 1, ()))
        np.random.RandomState(seed).shuffle(self._samples)

    def global_shuffle(self, fleet=None, thread_num=12):
        self.local_shuffle()

    def get_memory_data_size(self, fleet=None) -> int:
        return len(self._samples)

    def get_shuffle_data_size(self, fleet=None) -> int:
        return len(self._samples)

    def release_memory(self):
        self._samples = []

    def __iter__(self):
        return iter(self._samples)


class QueueDataset(InMemoryDataset):
    """The streaming variant: iterates the files lazily (reference:
    base/dataset.py QueueDataset)."""

    def load_into_memory(self):
        return None

    def __iter__(self):
        for path in self._files:
            with open(path, "r") as f:
                for line in f:
                    yield line.rstrip("\n")


class _SparseEntry:
    def __init__(self, kind: str, **kw):
        self.kind = kind
        self.config = kw

    def to_string(self) -> str:
        parts = [self.kind] + [f"{k}:{v}" for k, v in self.config.items()]
        return " ".join(parts)


class CountFilterEntry(_SparseEntry):
    """Admit a sparse feature after ``count_filter`` occurrences
    (reference: fleet entry attributes of large sparse tables)."""

    def __init__(self, count_filter: int = 0):
        super().__init__("count_filter_entry", count_filter=count_filter)


class ProbabilityEntry(_SparseEntry):
    def __init__(self, probability: float = 1.0):
        super().__init__("probability_entry", probability=probability)


class ShowClickEntry(_SparseEntry):
    def __init__(self, show_name: str = "show", click_name: str = "click"):
        super().__init__("show_click_entry", show_name=show_name,
                         click_name=click_name)


__all__ = [
    "ProcessMesh", "DistAttr", "ReduceType", "dtensor_from_fn",
    "unshard_dtensor", "shard_optimizer", "Strategy", "DistModel",
    "to_static", "ParallelEnv", "ParallelMode", "is_available",
    "is_initialized", "destroy_process_group", "get_backend", "get_group",
    "wait", "send", "recv", "isend", "irecv", "alltoall_single",
    "all_gather_object", "broadcast_object_list", "scatter_object_list",
    "gloo_init_parallel_env", "gloo_barrier", "gloo_release", "spawn",
    "split", "InMemoryDataset", "QueueDataset", "CountFilterEntry",
    "ProbabilityEntry", "ShowClickEntry"]
