"""Device mesh and sharding helpers, one process per GPU.

The reference's parallelism is pure shard-level data parallelism over Slurm
jobs (SURVEY §2.2). The JAX package's in-process alternative is a
``jax.sharding.Mesh`` over the chips of one program; PyTorch has no
single-controller multi-device program, so here the mesh is a grid of
``torch.distributed`` ranks, each its own process on its own device:

    rank = d * tp + m          (d: data index, m: model index)

The encode batch splits over the ``data`` axis (each rank encodes its own
block of rows) and params are replicated. The ``model`` axis is kept for
tensor-parallel experiments on the transformer bottleneck
(``shard_params_tp`` with ``mimi.model.encode(..., group=mesh.model_group)``),
but Mimi is ~80 M params, so dp-only is the production layout.

``make_mesh`` must run on every rank of the world, in the same order as
every other group-building call: ``torch.distributed.new_group`` is a
collective over the whole world, even for groups a rank is not in.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tokenize_audio_tpu_torch.config import resolve_device
from tokenize_audio_tpu_torch.mimi.config import MimiConfig
from tokenize_audio_tpu_torch.mimi.weights import params_to_torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (data, model) grid of ranks.

    ``data_index``/``model_index`` are None on a rank the grid leaves out
    (a world larger than dp * tp). ``model_group`` holds the ranks of this
    rank's data row (the tensor-parallel all-reduce), ``data_group`` those
    of its model column (the codes' all-gather); both are None without a
    process group."""

    dp: int
    tp: int
    data_index: Optional[int]
    model_index: Optional[int]
    device: torch.device
    world_size: int
    backend: Optional[str]
    model_group: Any = None
    data_group: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.dp, "model": self.tp}


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """Block ``index`` of ``parts`` equal blocks of a batch's leading axis."""

    index: int
    parts: int

    def span(self, n_rows: int) -> slice:
        per, rem = divmod(n_rows, self.parts)
        if rem:
            raise ValueError(
                f"batch of {n_rows} rows does not divide evenly over {self.parts} "
                "data blocks; size batches to a multiple of the data axis"
            )
        return slice(self.index * per, (self.index + 1) * per)


def _rank_device(device) -> torch.device:
    """The device this rank runs on: CUDA unless the caller names another
    (``resolve_device``), with the current CUDA device when no index is
    given (``multihost.init_distributed`` sets it)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    devices: Optional[Sequence[int]] = None,
    dp: Optional[int] = None,
    tp: int = 1,
    device: Optional[str | torch.device] = None,
) -> Mesh:
    """Build a (data, model) mesh over the ranks ``devices`` (default: every
    rank of the initialized process group), row-major as JAX's
    ``reshape(dp, tp)``. dp defaults to len(devices) // tp; ranks past
    dp * tp are left out. Without a process group the mesh is 1 x 1 on
    ``device``, so engine code paths are mesh-agnostic.

    ``device`` is this rank's device (CUDA unless the caller names
    another)."""
    device = _rank_device(device)
    if not dist.is_initialized():
        ranks, rank, world, backend = [0], 0, 1, None
    else:
        world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
        ranks = list(devices) if devices is not None else list(range(world))
    if dp is None:
        dp = len(ranks) // tp
    if dp < 1 or dp * tp > len(ranks):
        raise ValueError(
            f"mesh {dp}x{tp} needs {max(dp, 1) * tp} devices, found "
            f"{len(ranks)} — an empty/overshooting grid would otherwise "
            "surface as an obscure sharding error far from here"
        )
    grid = np.asarray(ranks[: dp * tp]).reshape(dp, tp)
    model_groups, data_groups = {}, {}
    if dist.is_initialized():
        # every rank builds every group, in the same order
        for d in range(dp):
            model_groups[d] = dist.new_group([int(r) for r in grid[d]])
        for m in range(tp):
            data_groups[m] = dist.new_group([int(r) for r in grid[:, m]])
    where = np.argwhere(grid == rank)
    d, m = (int(where[0][0]), int(where[0][1])) if len(where) else (None, None)
    return Mesh(
        dp=dp, tp=tp, data_index=d, model_index=m, device=device, world_size=world,
        backend=backend, model_group=model_groups.get(d), data_group=data_groups.get(m),
    )


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """This rank's block of the leading batch dimension: its data index's."""
    return BatchSharding(mesh.data_index, mesh.dp)


def replicate_params(params, mesh: Mesh):
    """The whole param tree on this rank's device."""
    return params_to_torch(params, mesh.device)


def shard_params_tp(params, mesh: Mesh, cfg: MimiConfig):
    """Megatron-style tensor-parallel slices of the transformer bottleneck
    for this rank's model index; everything else replicated.

    q/k/v and fc1 are column-parallel (this rank's block of output
    features: whole heads, a block of the MLP), o and fc2 row-parallel
    (the matching block of input features). ``mimi.model.encode`` with
    ``group=mesh.model_group`` all-reduces the row-parallel outputs, where
    XLA puts the psum under the JAX package's sharding. Takes ``cfg``,
    which the JAX function needs not, to refuse a split that would cut a
    head or the MLP unevenly (XLA would fail on it later)."""
    tp, m = mesh.tp, mesh.model_index
    for what, n in (("num_attention_heads", cfg.num_attention_heads),
                    ("intermediate_size", cfg.intermediate_size)):
        if n % tp:
            raise ValueError(f"{what} {n} does not split over the model axis ({tp})")

    def block(w, axis):
        n = w.shape[axis] // tp
        w = w[m * n : (m + 1) * n] if axis == 0 else w[:, m * n : (m + 1) * n]
        return w.contiguous() if isinstance(w, torch.Tensor) else w

    out = {k: v for k, v in params.items() if k != "tfm"}
    layers = []
    for lp in params["tfm"]:
        lp = dict(lp)
        for k in ("q", "k", "v", "fc1"):
            lp[k] = block(lp[k], 0)
        for k in ("o", "fc2"):
            lp[k] = block(lp[k], 1)
        layers.append(lp)
    out["tfm"] = layers
    return params_to_torch(out, mesh.device)
