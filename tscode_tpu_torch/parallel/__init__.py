'''Multi-device scale-out: row sharding over a device mesh, in one
process.'''

from tscode_tpu_torch.parallel.prune import (prune_collective_model,
                                             sharded_prune_rmsd)
from tscode_tpu_torch.parallel.sharding import (
    Mesh, default_mesh, get_default_mesh, make_mesh, mesh_for, mesh_wants,
    sharded_compenetration_mask, sharded_embed_screen_step,
    sharded_first_similar_successor, sharded_moments,
    sharded_screen_pipeline)

__all__ = ['Mesh', 'default_mesh', 'get_default_mesh', 'make_mesh',
           'mesh_for', 'mesh_wants', 'prune_collective_model',
           'sharded_compenetration_mask', 'sharded_embed_screen_step',
           'sharded_first_similar_successor', 'sharded_moments',
           'sharded_prune_rmsd', 'sharded_screen_pipeline']
