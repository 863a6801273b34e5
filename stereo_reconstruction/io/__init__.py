from stereo_reconstruction.io.pfm import read_pfm, write_pfm  # noqa: F401
from stereo_reconstruction.io.calib import parse_calib, Calibration  # noqa: F401
from stereo_reconstruction.io.image import read_image, write_image  # noqa: F401
from stereo_reconstruction.io.mesh_io import write_off  # noqa: F401
