from stereo_reconstruction.rectify.loop_zhang import (  # noqa: F401
    RectifyHomographies,
    loop_zhang_homographies,
)
from stereo_reconstruction.rectify.rectifier import (  # noqa: F401
    RectifiedPair,
    rectify_pair,
    disparity_to_original_frame,
)
from stereo_reconstruction.rectify.epilines import (  # noqa: F401
    draw_epilines,
    draw_rectified_epilines,
    epipolar_lines,
    epipole,
)
