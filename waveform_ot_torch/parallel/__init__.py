"""Meshes and sharding (counterpart of waveform_ot_tpu.parallel): trace-,
node- and start-sharding over a 1-D mesh, grid-column sharding of one
fingerprint, and both at once on a 2-D mesh. One process drives every shard;
see :mod:`waveform_ot_torch.parallel.mesh`."""

from waveform_ot_torch.parallel.mesh import (  # noqa: F401
    Mesh, Sharded, make_mesh, pjit_batched_misfit, replicate, shard_leading_axis,
    sharded_map, sharded_sum,
)
from waveform_ot_torch.parallel.grid_shard import (  # noqa: F401
    dp_sp_marg_misfit, grid_sharded_density, grid_sharded_marg_misfit,
    make_mesh_2d, shard_grid_axis,
)
