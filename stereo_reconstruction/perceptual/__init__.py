from stereo_reconstruction.perceptual.vgg import (  # noqa: F401
    get_params,
    init_vgg16_params,
    load_params_npz,
    save_params_npz,
    vgg16_features,
)
from stereo_reconstruction.perceptual.cost import (  # noqa: F401
    lpips_cost_volume,
    perceptual_window_search,
    windowed_lpips_search,
)
