"""The six-axis device mesh over ``torch.distributed``: counterpart of
``mpi_operator_tpu/parallel/mesh.py``.

One process drives one card, so a mesh is a layout of process ranks:
:func:`mesh_ranks` gives it (rank r where the JAX mesh puts device r),
and :func:`create_mesh` wraps it in a ``DeviceMesh`` with the axis names
``dp, fsdp, pp, ep, tp, sp``.  Inner axes vary fastest, so the ranks of
one ``fsdp`` group are neighbours (one node's NVLink) while ``dp`` spans
nodes or slices.  JAX's ``batch_sharding``/``seq_batch_sharding`` have
no torch meaning: a rank holds the rows :func:`batch_rows` names.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api import constants


@dataclass
class MeshConfig:
    """Mesh axis sizes; -1 on dp means "use all remaining processes"."""
    dp: int = -1     # data parallel (gradients all-reduced; across nodes)
    fsdp: int = 1    # parameter/optimizer sharding (ZeRO-3; in a node)
    pp: int = 1      # pipeline parallel
    ep: int = 1      # expert parallel
    tp: int = 1      # tensor parallel
    sp: int = 1      # sequence/context parallel

    def resolve(self, n_devices: int) -> tuple:
        fixed = self.fsdp * self.pp * self.ep * self.tp * self.sp
        dp = self.dp
        if dp == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by"
                    f" fsdp*pp*ep*tp*sp={fixed}")
            dp = n_devices // fixed
        if dp * fixed != n_devices:
            raise ValueError(
                f"mesh {dp}x{self.fsdp}x{self.pp}x{self.ep}x{self.tp}"
                f"x{self.sp} != {n_devices} devices")
        return (dp, self.fsdp, self.pp, self.ep, self.tp, self.sp)


AXIS_NAMES = ("dp", "fsdp", "pp", "ep", "tp", "sp")
# Axes over which the batch is sharded (gradient reduction axes).
BATCH_AXES = ("dp", "fsdp")


def mesh_ranks(config: Optional[MeshConfig], world: int,
               num_slices: int = 1) -> np.ndarray:
    """Ranks laid out in the mesh's shape: rank r sits where the JAX mesh
    over ``world`` devices puts device r.  With ``num_slices`` > 1 every
    slice is a contiguous block of ranks and ``dp`` is the outer axis
    across slices (the JAX virtual-slice layout)."""
    shape = (config or MeshConfig()).resolve(world)
    if num_slices > 1:
        if world % num_slices != 0:
            raise ValueError(f"{world} devices not divisible by "
                             f"{num_slices} slices")
        if shape[0] % num_slices != 0:
            raise ValueError(
                f"dp={shape[0]} must be a multiple of num_slices="
                f"{num_slices}: dp is the only DCN-friendly axis, so every"
                f" slice boundary must land on it")
    return np.arange(world).reshape(shape)


def create_mesh(config: Optional[MeshConfig] = None, device_type=None,
                num_slices: int = 1):
    """A ``DeviceMesh`` with axes (dp, fsdp, pp, ep, tp, sp) over the
    default process group (:func:`mesh_ranks` lays the ranks out).
    ``device_type`` defaults to ``"cuda"``; ``"cpu"`` gives a gloo mesh.
    Every rank must call it (the axis groups form collectively)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "bootstrap.initialize_from_env() first")
    ranks = mesh_ranks(config, dist.get_world_size(), num_slices)
    return DeviceMesh(device_type or "cuda", ranks.tolist(),
                      mesh_dim_names=AXIS_NAMES)


def create_multislice_mesh(config: Optional[MeshConfig] = None,
                           num_slices: int = 1, device_type=None):
    """The mesh of a job that spans ``num_slices`` slices: dp is the
    outer axis across slices, every other axis stays inside a slice."""
    return create_mesh(config, device_type, num_slices)


def batch_rows(mesh_shape, coordinate, global_batch: int) -> slice:
    """The rows of a global batch that the rank at ``coordinate`` (its
    index on each mesh axis) holds: the batch is split over (dp, fsdp),
    block ``dp_index * fsdp + fsdp_index``, as JAX's
    ``PartitionSpec(("dp", "fsdp"))``; ranks that differ only on the
    other axes hold the same rows."""
    sizes = dict(zip(AXIS_NAMES, mesh_shape))
    index = dict(zip(AXIS_NAMES, coordinate))
    shards = sizes["dp"] * sizes["fsdp"]
    if global_batch % shards:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"dp*fsdp={shards}")
    rows = global_batch // shards
    block = index["dp"] * sizes["fsdp"] + index["fsdp"]
    return slice(block * rows, (block + 1) * rows)


# ---------------------------------------------------------------------------
# The gang scheduler's placement (the port's copy of the decoder in
# mpi_operator_tpu/sched/topology.py)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Block:
    """An axis-aligned sub-torus: ``origin`` + ``shape``."""
    origin: Tuple[int, ...]
    shape: Tuple[int, ...]

    @property
    def chips(self) -> int:
        return math.prod(self.shape)

    def coords(self) -> List[Tuple[int, ...]]:
        out = [()]
        for o, s in zip(self.origin, self.shape):
            out = [c + (o + i,) for c in out for i in range(s)]
        return out


def decode_placement(text: str) -> Optional[Dict[str, List[Block]]]:
    """``"slice-a=0.0/16x16;slice-b=0.0/8x8"`` -> {slice: [Block, ...]};
    None on any malformed input."""
    if text == "":
        return {}
    out: Dict[str, List[Block]] = {}
    for part in text.split(";"):
        name, sep, body = part.partition("=")
        if not sep or not name or not body or name in out:
            return None
        blocks: List[Block] = []
        for raw in body.split("+"):
            origin_raw, bsep, shape_raw = raw.partition("/")
            if not bsep:
                return None
            try:
                origin = tuple(int(v) for v in origin_raw.split("."))
                shape = tuple(int(v) for v in shape_raw.split("x"))
            except ValueError:
                return None
            if len(origin) != len(shape) or not shape \
                    or any(v < 0 for v in origin) \
                    or any(v <= 0 for v in shape):
                return None
            blocks.append(Block(origin, shape))
        out[name] = blocks
    return out


def placement_from_env():
    """The gang scheduler's topology surface in a worker pod:
    ``{"placement": {slice: [Block, ...]}, "num_slices": int,
    "slice": str|None, "coords": tuple|None}``, or None outside a
    scheduler-placed gang.  ``num_slices`` is the argument for
    :func:`create_multislice_mesh`."""
    raw = os.environ.get(constants.PLACEMENT_ENV)
    if not raw:
        return None
    placement = decode_placement(raw)
    if not placement:
        return None
    coords_raw = os.environ.get(constants.CHIP_COORDS_ENV, "")
    coords = None
    if coords_raw:
        try:
            coords = tuple(int(v) for v in coords_raw.split("."))
        except ValueError:
            coords = None
    # NUM_SLICES_ENV is the injected value; the decoded placement is the
    # fallback.
    try:
        num_slices = int(os.environ.get(constants.NUM_SLICES_ENV, ""))
    except ValueError:
        num_slices = len(placement)
    return {
        "placement": placement,
        "num_slices": num_slices,
        "slice": os.environ.get(constants.SLICE_NAME_ENV) or None,
        "coords": coords,
    }
