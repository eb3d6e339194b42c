"""Several processes on ``torch.distributed``: the port's process layer.

The JAX package places data on a device mesh and lets XLA insert the
collectives; here each process (a rank) drives one device and the
collectives are explicit. A launcher such as ``torchrun`` starts the ranks
and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; ``initialize_distributed`` reads them
and brings the process group up. Without that environment every helper here
is a one-process no-op, so the same code serves one process and several.

The backend follows from the layout, decided before the group starts:
``nccl`` when every rank on the host has a CUDA card of its own, ``gloo`` on
the CPU or when ranks share a card (NCCL refuses two ranks on one device).
Under gloo, collectives on CUDA tensors go through host copies; under
NCCL, collectives on host tensors go through copies on the current card.

Data parallelism is by rows: every rank takes the same contiguous block of
each global batch (``shard_along``), weights start equal by a broadcast
from rank 0 (``replicate``), and whatever a global batch normalises by is
summed over the ranks (``all_sum``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = [
    "initialize_distributed", "choose_backend", "is_primary", "rank",
    "world_size", "local_device", "make_mesh", "allgather_object",
    "all_sum", "shard_along", "replicate", "pad_to_multiple",
]


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the process group; 1 without a group."""
    return dist.get_world_size() if _group_up() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if _group_up() else 0


def is_primary() -> bool:
    """True on the process that writes artifacts (rank 0)."""
    return rank() == 0


def _wants_cpu(device) -> bool:
    return device is not None and torch.device(device).type == "cpu"


def local_device(device=None) -> torch.device:
    """This rank's device: the CPU when ``device`` asks for it, else
    ``cuda:LOCAL_RANK`` (modulo the visible cards, so ranks that outnumber
    the cards share them). Raises without CUDA unless the CPU is asked
    for."""
    if _wants_cpu(device):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run on the CPU explicitly")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(device=None) -> tuple[str, str]:
    """(backend, reason) for this host's layout: ``nccl`` when every local
    rank has a card of its own, else ``gloo``."""
    if _wants_cpu(device) or not torch.cuda.is_available():
        return "gloo", "ranks on the CPU"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", "1")))
    cards = torch.cuda.device_count()
    if local_world > cards:
        return "gloo", f"{local_world} ranks share {cards} card(s)"
    return "nccl", "every rank has a card of its own"


def initialize_distributed(device=None) -> None:
    """Bring the process group up from the launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    make this rank's card the current CUDA device. A no-op without
    ``WORLD_SIZE`` in the environment (one process) or when a group is
    already up. Rank 0 prints the backend chosen and why.

    :param device: "cpu" puts the ranks on the CPU (gloo); None or "cuda"
        puts each on ``local_device()``.
    """
    if not dist.is_available() or _group_up() \
            or "WORLD_SIZE" not in os.environ:
        return
    world = int(os.environ["WORLD_SIZE"])
    me = int(os.environ.get("RANK", "0"))
    backend, why = choose_backend(device)
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # env://: under torchrun the ranks join the store its agent holds
    os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
    os.environ.setdefault("MASTER_PORT", "29500")
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=me)
    if me == 0:
        print(f"[distributed] backend={backend} world_size={world} ({why})",
              flush=True)


def make_mesh(device=None) -> list:
    """The devices of this process that data-parallel work is dealt over:
    every visible CUDA card, or the CPU alone when ``device`` asks for it."""
    if _wants_cpu(device) or not torch.cuda.is_available():
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def allgather_object(obj) -> list:
    """Every rank's picklable ``obj`` (payloads may differ in size), as a
    list ordered by rank; ``[obj]`` in one process. Under NCCL the current
    CUDA device must be this rank's (``initialize_distributed`` sets it)."""
    n = world_size()
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj)
    return out


def _collective_(op, t: torch.Tensor) -> torch.Tensor:
    """``op(t)`` in place on a tensor the backend takes: gloo gets a host
    copy of a CUDA tensor (it does not take every collective on them),
    NCCL a copy on the current card of a host tensor."""
    backend = dist.get_backend()
    if t.is_cuda and backend == "gloo":
        buf = t.cpu()
    elif not t.is_cuda and backend == "nccl":
        buf = t.to(torch.device("cuda", torch.cuda.current_device()))
    else:
        op(t)
        return t
    op(buf)
    return t.copy_(buf)


def _all_reduce_(t: torch.Tensor) -> torch.Tensor:
    return _collective_(dist.all_reduce, t)


def _broadcast_(t: torch.Tensor) -> torch.Tensor:
    return _collective_(lambda b: dist.broadcast(b, src=0), t)


def all_sum(x):
    """The sum of ``x`` over every rank, equal on all of them; ``x`` itself
    in one process. ``x``: a tensor (a new one, detached), a Python number,
    or a list of tensors (summed as one flat buffer)."""
    if world_size() == 1:
        return x
    if isinstance(x, (list, tuple)):
        flat = torch.cat([t.detach().reshape(-1) for t in x])
        _all_reduce_(flat)
        out, at = [], 0
        for t in x:
            out.append(flat[at:at + t.numel()].view_as(t))
            at += t.numel()
        return out
    if torch.is_tensor(x):
        return _all_reduce_(x.detach().clone())
    return type(x)(_all_reduce_(torch.tensor(x, dtype=torch.float64)).item())


def shard_along(x, dim: int = 0):
    """This rank's contiguous block of ``x`` along ``dim`` (a tensor, an
    array or a list; ``dim`` 0 for a list): the rows ``[r * n / W, (r + 1) *
    n / W)`` of the ``n`` rows. ``n`` must be a multiple of the world
    size."""
    n, w = (len(x) if isinstance(x, list) else x.shape[dim]), world_size()
    if n % w:
        raise ValueError(f"{n} rows do not split over {w} ranks")
    k = n // w
    sl = slice(rank() * k, (rank() + 1) * k)
    if isinstance(x, list):
        return x[sl]
    return x[(slice(None),) * dim + (sl,)]


def replicate(x):
    """Rank 0's ``x`` on every rank: a module's parameters and buffers are
    broadcast in place (the module is returned); any other picklable object
    is sent whole. ``x`` in one process."""
    if world_size() == 1:
        return x
    if isinstance(x, torch.nn.Module):
        for t in list(x.parameters()) + list(x.buffers()):
            _broadcast_(t.data)
        return x
    box = [x]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def pad_to_multiple(n: int, k: int) -> int:
    return -(-n // k) * k
