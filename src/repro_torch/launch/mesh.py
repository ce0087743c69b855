"""Production mesh construction (the dry run's meshes).

The counterpart of the JAX package's ``launch/mesh.py``. A FUNCTION, not a
module constant: importing this module touches no process group. The mesh
is laid over the ranks of the group ``distributed.sharding`` brought up
(``init_mesh_group`` on a real cluster, ``init_fake_group`` for a dry run
of 256 or 512 ranks in one process).
"""

from __future__ import annotations

from repro_torch.distributed.sharding import ShardCtx, make_mesh

__all__ = ["make_production_mesh", "make_ctx"]


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 over ("data", "model"), or 2 x 16 x 16 over ("pod", "data",
    "model") with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_ctx(mesh) -> ShardCtx:
    data_axes = (
        ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
    )
    return ShardCtx(mesh=mesh, data_axes=data_axes, model_axis="model")
