"""Packaging for uemda_tpu.

The C++ superpixel runtime (native/superpixels.cpp) is compiled lazily on
first use with g++ and cached next to the source
(uemda_tpu/superpixels/native.py), so no build step or compiler extension
module is required at install time — the source ships as data and any host
with g++ can JIT it. (In this dev environment pip installs are offline;
run from the repo root instead.)
"""

from setuptools import find_packages, setup

setup(
    name="uemda_tpu",
    version="0.1.0",
    description=(
        "TPU-native JAX framework for uncertainty-aware domain-adaptive "
        "remote-sensing segmentation"
    ),
    packages=find_packages(include=["uemda_tpu", "uemda_tpu.*",
                                    "uemda_tpu_torch", "uemda_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.30",
        "flax>=0.8",
        "optax>=0.2",
        "numpy",
        "pillow",
        "scikit-image",
    ],
    extras_require={
        "torch-port": ["torch"],  # checkpoint porting only
        "analysis": ["scikit-learn", "matplotlib"],
    },
    data_files=[("uemda_tpu_native", ["native/superpixels.cpp"])],
)
