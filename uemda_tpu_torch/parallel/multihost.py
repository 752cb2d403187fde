"""Multi-process runs: the process group, the rank guards, the batch slice
and the CLIs' flags.

The port's counterpart of ``uemda_tpu/parallel/multihost.py``. A JAX
process drives every chip of its host; a PyTorch process here drives one
device. So:

* ``--num-devices N`` (N > 1) makes a CLI start N local processes itself
  (``torch.multiprocessing``, :func:`launch`), rank i on ``cuda:i`` over
  NCCL, or, with ``--device cpu``, on the CPU over gloo. One command does
  what the JAX tool's one command does.
* ``--multihost 1`` joins a group of processes started elsewhere (one per
  device, on one host or many): ``--coordinator host:port``,
  ``--num-processes`` and ``--process-id``, or the environment variables
  ``torchrun`` sets (``MASTER_ADDR`` + ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``, and ``LOCAL_RANK`` for the device).

:func:`init_multihost` creates the default group (NCCL for the card, gloo
for the CPU) and then runs one warm-up collective while every process is
at the same cheap point, as the JAX package's warm-up barrier
(``multihost.py:69-77``): the group's connections are set up there and not
at the first collective of a step, where a peer may still be building its
model. :func:`process_index`, :func:`process_count` and
:func:`is_main_process` guard what only process 0 does (logging, the run
dir, snapshots, evaluation); :func:`local_batch_slice` gives this
process's rows of every global batch. The JAX package's ``fetch_local``
has no counterpart: a torch rank holds its whole replicated state.

The group's collectives wait ``TIMEOUT`` (an hour) before they fail: long
enough for the other ranks to wait while process 0 evaluates or sweeps.
"""

import datetime
import os
import socket
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from uemda_tpu_torch.parallel.mesh import rank, world_size


TIMEOUT = datetime.timedelta(seconds=3600)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, device=None,
                   local_rank: Optional[int] = None) -> torch.device:
    """Join the default process group at ``coordinator_address``
    (``host:port``; else ``MASTER_ADDR``:``MASTER_PORT``) as rank
    ``process_id`` (else ``RANK``) of ``num_processes`` (else
    ``WORLD_SIZE``): NCCL on this process's card, or gloo when ``device``
    is 'cpu'. Returns this process's device."""
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not (addr and port):
            raise ValueError("--multihost: give --coordinator host:port or "
                             "set MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{addr}:{port}"
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cpu":
        # this process's card: LOCAL_RANK, else the rank modulo the cards
        if local_rank is None:
            env = os.environ.get("LOCAL_RANK")
            local_rank = int(env) if env else \
                int(process_id) % max(torch.cuda.device_count(), 1)
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo" if dev.type == "cpu" else "nccl",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=TIMEOUT)
    warm = torch.zeros(1, device=dev)
    dist.all_reduce(warm)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return dev


def process_index() -> int:
    return rank()


def process_count() -> int:
    return world_size()


def is_main_process() -> bool:
    return rank() == 0


def local_batch_slice(global_batch_size: int) -> Tuple[int, int]:
    """(start, size) of this process's rows within every global batch; the
    global batch divides evenly (asserted), so the processes' consecutive
    slices line up with their ranks."""
    n = process_count()
    assert global_batch_size % n == 0, (
        f"global batch {global_batch_size} not divisible by {n} processes")
    local = global_batch_size // n
    return process_index() * local, local


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def _env_coordinator() -> Optional[str]:
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def add_multihost_flags(parser) -> None:
    """The CLIs' process flags, under the JAX tools' names and defaults
    (``multihost.py:120-133``), with torchrun's environment variables in
    place of ``JAX_*``."""
    parser.add_argument(
        "--multihost", dest="multihost", type=int, default=0,
        help="join a process group started elsewhere, one process a device "
             "(--coordinator/--num-processes/--process-id, or torchrun's "
             "MASTER_ADDR+MASTER_PORT/WORLD_SIZE/RANK/LOCAL_RANK)")
    parser.add_argument("--coordinator", type=str, default=_env_coordinator())
    parser.add_argument("--num-processes", type=int,
                        default=_env_int("WORLD_SIZE"))
    parser.add_argument("--process-id", type=int, default=_env_int("RANK"))


def setup_multihost(args) -> bool:
    """Join the group from parsed flags; True when ``--multihost``."""
    if not getattr(args, "multihost", 0):
        return False
    init_multihost(args.coordinator, args.num_processes, args.process_id,
                   device=getattr(args, "device", None))
    return True


def trainer_mesh(args, multihost: bool) -> Optional[int]:
    """The one rule every CLI shares (``multihost.py:148-160``): the number
    of ranks of the run -- every process of the group under
    ``--multihost``, ``--num-devices`` local processes when it is > 1 --
    or None for one process on one device."""
    if multihost:
        return process_count()
    n = getattr(args, "num_devices", None) or 0
    return n if n > 1 else None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(local_rank: int, main: Callable, args, port: int, n: int):
    init_multihost(f"127.0.0.1:{port}", n, local_rank,
                   device=getattr(args, "device", None),
                   local_rank=local_rank)
    try:
        main(args)
    finally:
        dist.destroy_process_group()


def launch(main: Callable, args):
    """Run a CLI's ``main(args)``: in this process (one device, or one
    rank of a ``--multihost`` group), or, with ``--num-devices`` N > 1, in
    N processes this call starts and waits for (rank i on ``cuda:i``, or
    on the CPU with ``--device cpu``). Returns ``main``'s result in this
    process, None from the started ones."""
    multihost = setup_multihost(args)
    n = trainer_mesh(args, multihost)
    if multihost or n is None:
        try:
            return main(args)
        finally:
            if multihost:
                dist.destroy_process_group()
    cpu = torch.device(getattr(args, "device", None) or "cuda").type == "cpu"
    if not cpu and torch.cuda.device_count() < n:
        raise RuntimeError(f"--num-devices {n}: this host has "
                           f"{torch.cuda.device_count()} CUDA devices")
    _spawn(main, args, n)
    return None


def _spawn(main: Callable, args, n: int) -> None:
    """``n`` local ranks of ``main(args)``, waited for; one that fails
    raises here."""
    import torch.multiprocessing as mp

    mp.spawn(_spawned, args=(main, args, _free_port(), n), nprocs=n,
             join=True)
