"""Build hook: compile the native IO runtime into the package.

Metadata lives in pyproject.toml; this only adds the `make -C native`
step (native/stereo_io.cpp -> stereo_reconstruction/io/
libstereo_io.so) to build_py so wheels and editable installs ship the
native PNG/PFM/prefetch runtime. A missing toolchain degrades to the
pure-Python IO fallback (io/native.py) with a warning, not a failure.
"""

import os
import shutil
import subprocess
import sys

from setuptools import setup
from setuptools.command.build_py import build_py

ROOT = os.path.dirname(os.path.abspath(__file__))


class BuildWithNative(build_py):
    def run(self):
        so = os.path.join(ROOT, "native", "libstereo_io.so")
        try:
            subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                           check=True)
        except (OSError, subprocess.CalledProcessError) as exc:
            sys.stderr.write(
                f"warning: native IO build failed ({exc}); the package "
                "will use the pure-Python IO fallback\n")
        if os.path.exists(so):
            dest = os.path.join(ROOT, "stereo_reconstruction", "io",
                                "libstereo_io.so")
            shutil.copy2(so, dest)
        super().run()


setup(cmdclass={"build_py": BuildWithNative})
