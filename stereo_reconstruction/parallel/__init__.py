from stereo_reconstruction.parallel.mesh import make_mesh  # noqa: F401
from stereo_reconstruction.parallel.sharded import (  # noqa: F401
    sharded_block_search_right,
    sharded_evaldisp,
)
from stereo_reconstruction.parallel.ba_dist import (  # noqa: F401
    distributed_bundle_adjust,
    distributed_bundle_adjust_batch,
)
