"""Multi-process helpers for in-process data parallelism under
``torch.distributed``.

The production layout is the reference's shared-nothing cluster DP — one
engine process per GPU, fanned out by ``runner/pod_runner.py`` with
hub-as-ledger idempotence (SURVEY §2.2) — which needs nothing from this
module. These helpers cover the OPTIONAL in-process alternative: one
logical engine spanning every GPU of a world of processes (one per GPU).

    from tokenize_audio_tpu_torch.parallel import multihost
    multihost.init_distributed()            # torchrun's environment
    mesh = multihost.global_mesh()          # every rank of the world
    engine = MimiEncoderEngine(params, cfg, ecfg, mesh=mesh)

Run under ``torchrun --nproc-per-node N script.py``; every rank passes the
same utterance list to ``encode_batch`` and gets the full result.

PyTorch has no global array, so ``host_local_to_global`` hands back the
rank's own rows as a tensor on its device and ``local_rows`` reads them
back as numpy: each rank feeds and reads only its own rows, and no audio
crosses processes. The engine's multiprocess branch
(``MimiEncoderEngine._dispatch``) uses a different upload model: every rank
passes the same full utterance list (keeping the collective schedule the
same on every rank), plans the same batches, uploads only its data block's
rows, and all-gathers the small code arrays over the mesh's data group —
valid for ANY (data, model) decomposition, including tp spanning processes
where neighbour ranks compute replicas of one data block. The helpers
below remain the right tool for the pure-DP layout where each rank feeds
distinct rows.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tokenize_audio_tpu_torch.config import resolve_device
from tokenize_audio_tpu_torch.parallel.mesh import make_mesh

# how long a collective (and the rendezvous) waits for a missing rank
# before it raises: a rank that fails must end its peers, not stall them
TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Optional[str | torch.device] = None,
) -> torch.device:
    """Join the process group and return this rank's device.

    With the three JAX arguments None, torchrun's environment (``env://``:
    MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) says where to meet; else
    ``coordinator_address`` is a ``host:port`` (TCP) or any
    ``init_process_group`` URL (``file://`` for a FileStore), with the world
    size and this rank. The device is ``device``, else ``cuda:{LOCAL_RANK}``
    (raises without a card, as ``resolve_device`` does); the backend is
    ``backend``, else NCCL for a CUDA device and gloo for the CPU. Neither
    is ever switched on the caller's behalf."""
    args = (coordinator_address, num_processes, process_id)
    if all(a is None for a in args):
        init = "env://"
    elif any(a is None for a in args):
        raise ValueError(
            "pass coordinator_address, num_processes and process_id together, "
            "or none of them (torchrun's environment)"
        )
    else:
        init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dev = resolve_device(
        device if device is not None else f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    )
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {} if init == "env://" else {"world_size": num_processes, "rank": process_id}
    dist.init_process_group(
        backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init,
        timeout=TIMEOUT,
        **kwargs,
    )
    return dev


def global_mesh(dp: Optional[int] = None, tp: int = 1, device=None):
    """A (data, model) mesh over every rank of the world. Identical to
    parallel.mesh.make_mesh, explicit that the grid spans processes."""
    return make_mesh(dp=dp, tp=tp, device=device)


def host_local_to_global(batch: np.ndarray, mesh) -> torch.Tensor:
    """This rank's rows of a batch-sharded batch, on its device.

    JAX assembles one global array from every process's rows; PyTorch has
    none, so the rank keeps its own ``batch`` as its block of the data
    axis: the global batch is ``batch.shape[0] * dp`` rows and no audio
    crosses processes. Suits the pure-DP layout only (one rank per data
    block)."""
    return torch.from_numpy(np.ascontiguousarray(batch)).to(mesh.device)


def local_rows(rows: torch.Tensor) -> np.ndarray:
    """This rank's rows as numpy, in axis order — the inverse of
    host_local_to_global for reading results back without fetching other
    ranks' rows."""
    return rows.cpu().numpy()


def process_span(n_global_rows: int) -> tuple[int, int]:
    """[start, stop) row range this process owns of an evenly batch-sharded
    global axis. The batch MUST divide evenly over the processes (the
    engine sizes every batch to a multiple of dp); flooring a remainder
    away here would silently never encode those rows."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    per, rem = divmod(n_global_rows, world)
    if rem:
        raise ValueError(
            f"batch of {n_global_rows} rows does not divide evenly over "
            f"{world} processes; size batches to a multiple of the process count"
        )
    start = per * (dist.get_rank() if dist.is_initialized() else 0)
    return start, start + per
