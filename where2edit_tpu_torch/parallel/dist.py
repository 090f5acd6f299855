"""Data parallelism over ``torch.distributed``, one process per card
(counterpart of where2edit_tpu/parallel/mesh.py).

The JAX package shards the global batch over a mesh's ``data`` axis and
lets GSPMD insert the gradient all-reduce; its sharded step is the
single-device step on the global batch. Here each rank is a process that
holds the whole model and its rows of the global batch (``rows``); the
trainers average their gradients explicitly (``all_reduce_grads``) before
every optimizer step, and every random draw is the global draw, made on
every rank, of which each rank keeps its rows. Outside a group every helper
answers as one process would (rank 0 of 1, no collective), so the
single-process code path is the one without a group.

``launch`` starts the ranks as the reference's ``mp.spawn`` did
(attention/run_attention.py:913-945): NCCL and one card per rank on CUDA,
gloo on the CPU, with a ``file://`` rendezvous in a temporary directory (no
TCP port to race for). A world of one runs in the calling process.
``initialize_multihost`` joins the group ``torchrun`` describes instead.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from where2edit_tpu_torch.utils import profiling

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _backend(device) -> str:
    return "nccl" if torch.device(device or "cuda").type == "cuda" else "gloo"


# the group a step's batch is split over: the whole group but under spatial
# parallelism, where the members of one SP group hold the same rows
_data_group = None


def in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def world() -> int:
    return dist.get_world_size() if in_group() else 1


def data_group():
    """The process group the global batch is split over (None: the whole
    group)."""
    return _data_group


def data_rank() -> int:
    return dist.get_rank(_data_group) if in_group() else 0


def data_world() -> int:
    return dist.get_world_size(_data_group) if in_group() else 1


def split_groups(sp: int):
    """Split the group into data-parallel × spatial-parallel: rank r = d·sp
    + s is member s of SP group d (ranks d·sp … d·sp + sp − 1) and member d
    of data group s (ranks s, s + sp, …). Every rank creates every group, as
    ``torch.distributed`` requires. Sets this rank's data group (``rows``,
    the gradient average and the batch gathers run over it) and returns its
    SP group."""
    global _data_group
    n, r = world(), rank()
    if sp < 1 or n % sp:
        raise ValueError(f"--sp {sp} does not divide the group's {n} ranks")
    mine = None
    for d in range(n // sp):
        g = dist.new_group(list(range(d * sp, (d + 1) * sp)))
        if d == r // sp:
            mine = g
    for s in range(sp):
        g = dist.new_group(list(range(s, n, sp)))
        if s == r % sp:
            _data_group = g
    return mine


def is_main() -> bool:
    return rank() == 0


def comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize_multihost(device=None) -> bool:
    """Join the process group that ``torchrun`` describes in the
    environment (``init_method="env://"``; ``LOCAL_RANK`` picks the card).
    True when this process is (now) in a group; a no-op returning False
    when the environment describes none, so one process runs unchanged."""
    if in_group():
        return True
    if not all(k in os.environ for k in _TORCHRUN_ENV):
        return False
    if torch.device(device or "cuda").type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(_backend(device), init_method="env://")
    return True


def _run(rank_: int, fn, world_: int, device, init: str, timeout_s: float, args):
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and dev.index is None:
        torch.cuda.set_device(rank_)
    dist.init_process_group(_backend(device), init_method=init, world_size=world_,
                            rank=rank_, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        return fn(*args)
    finally:
        global _data_group
        _data_group = None
        dist.destroy_process_group()


def launch(fn, world_: int, device, *args, store_dir: str | None = None,
           timeout_s: float = 1800.0):
    """Run ``fn(*args)`` on ``world_`` ranks of a new group: one process per
    rank (``torch.multiprocessing.spawn``; ``fn`` and ``args`` must pickle),
    each on card ``rank`` under NCCL when ``device`` is CUDA, under gloo on
    the CPU. The rendezvous is a ``file://`` store in ``store_dir`` (a new
    temporary directory by default, removed afterwards). A world of one runs
    in this process and returns ``fn``'s value; a spawned world returns None
    and raises if any rank failed."""
    tmp = store_dir or tempfile.mkdtemp(prefix="w2e-dist-")
    store = os.path.join(tmp, "store")
    if os.path.exists(store):
        os.remove(store)
    init = "file://" + store
    try:
        if world_ == 1:
            return _run(0, fn, 1, device, init, timeout_s, args)
        mp.spawn(_run, args=(fn, world_, device, init, timeout_s, args),
                 nprocs=world_, join=True)
        return None
    finally:
        if store_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def quiet_unless_main():
    """``sys.stdout`` goes nowhere on ranks other than 0, so a group prints
    each line once."""
    if is_main():
        yield
        return
    stdout = sys.stdout
    with open(os.devnull, "w") as sys.stdout:
        try:
            yield
        finally:
            sys.stdout = stdout


def rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's equal slice of the global batch ``x`` along dim 0 (all
    of it outside a group), by its place in the data group."""
    n = data_world()
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split over {n} ranks")
    k = x.shape[0] // n
    return x[data_rank() * k:(data_rank() + 1) * k]


def all_reduce_grads(params) -> None:
    """Each parameter's ``.grad`` averaged over the ranks, through one
    flattened fp32 bucket (the gradient all-reduce GSPMD inserts in the JAX
    trainers). Parameters without a gradient are left so (every rank has
    the same graph, so the same ones). No-op outside a group; inside one,
    the tracer's span ``parallel.all_reduce_grads``."""
    if not in_group():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    with profiling.span("parallel.all_reduce_grads"):
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, group=_data_group)
        flat.div_(data_world())
        parts = flat.split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in zip(parts, grads)])


def mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data group's ranks (``x`` itself outside
    a group)."""
    if not in_group():
        return x
    y = x.detach().to(comm_device(), copy=True)
    dist.all_reduce(y, group=_data_group)
    return (y / data_world()).to(x.device)


def mean_scalars(values: dict) -> dict:
    """{name: 0-dim tensor} averaged over the ranks in one all-reduce."""
    if not in_group() or not values:
        return values
    keys = list(values)
    avg = mean(torch.stack([torch.as_tensor(values[k]).float().to(comm_device())
                            for k in keys]))
    return {k: v.to(torch.as_tensor(values[k]).device) for k, v in zip(keys, avg.unbind())}


def sum_floats(*values: float) -> list:
    """Host floats summed over the ranks (float64), in one all-reduce."""
    if not in_group():
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=comm_device())
    dist.all_reduce(t, group=_data_group)
    return t.tolist()


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any (a MAX all-reduce)."""
    if not in_group():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], device=comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_object(obj):
    """Rank 0's ``obj`` (any picklable value) on every rank."""
    if not in_group():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=comm_device())
    return box[0]


def gather_rows(x: torch.Tensor, steps: int = 1):
    """The data group's ``x`` concatenated on rank 0 in the global order
    (None on the others). ``x`` holds ``steps`` equal blocks, one per step of
    a loop that took this rank's rows of each step's global batch; the
    result interleaves them as the single-process loop would have: step 0's
    rows of data rank 0, of data rank 1, ..., then step 1's. Under spatial
    parallelism only rank 0's data group gathers (the other members of an SP
    group hold the same rows)."""
    if not in_group():
        return x
    if _data_group is not None and dist.get_global_rank(_data_group, 0) != 0:
        return None
    src = x.contiguous().to(comm_device())
    parts = [torch.empty_like(src) for _ in range(data_world())] if is_main() else None
    dist.gather(src, parts, dst=0, group=_data_group)
    if not is_main():
        return None
    blocks = [p.reshape(steps, -1, *p.shape[1:]) for p in parts]
    out = torch.stack(blocks, 1)
    return out.reshape(-1, *x.shape[1:]).to(x.device)


def barrier() -> None:
    if not in_group():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
