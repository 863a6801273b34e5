from stereo_reconstruction.data.records import StereoPair  # noqa: F401
from stereo_reconstruction.data.middeval3 import MiddEval3  # noqa: F401
from stereo_reconstruction.data.hitnet import (  # noqa: F401
    PrecomputedDisparities,
    average_disparity,
    read_grayscale_disparity,
    read_hitnet_disparity,
    rescale_to_gt_mean,
)
