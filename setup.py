"""Build hook: stage the native IO source into the wheel.

The canonical native source lives at the repo root (native/image_io.cpp —
kept there so the C++ core is visible as a first-class component, with its
own build dir and tests). Wheels must carry it inside the package so
`utils/native.py` can JIT-build it post-install; this hook copies it to
stablekeypoints_tpu/_native_src/ at build time. Editable installs skip the
copy and resolve the repo-root path directly (utils/native.py checks both).
The PyTorch port's `utils/native.py` builds the same source from its own
stablekeypoints_tpu_torch/_native_src/.
All metadata lives in pyproject.toml.
"""

import os
import shutil

from setuptools import setup
from setuptools.command.build_py import build_py


class BuildPyWithNativeSrc(build_py):
    def run(self):
        super().run()
        root = os.path.dirname(os.path.abspath(__file__))
        src = os.path.join(root, "native", "image_io.cpp")
        if os.path.exists(src):
            # both packages build it: the JAX one and the PyTorch port
            for pkg in ("stablekeypoints_tpu", "stablekeypoints_tpu_torch"):
                dst_dir = os.path.join(self.build_lib, pkg, "_native_src")
                os.makedirs(dst_dir, exist_ok=True)
                shutil.copy2(src, os.path.join(dst_dir, "image_io.cpp"))


setup(cmdclass={"build_py": BuildPyWithNativeSrc})
