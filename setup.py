"""Packaging for puresound_tpu (parity: reference setup.py + build script).

The native audio decoder (csrc/) is built on demand at runtime via
puresound_tpu.src.native.build(); no compiled artifacts ship in the sdist.
"""
from setuptools import find_packages, setup

setup(
    name="puresound_tpu",
    version="0.1.0",
    description=("A TPU-native (JAX/XLA/Pallas) speech enhancement and "
                 "source separation framework"),
    packages=find_packages(include=["puresound_tpu", "puresound_tpu.*",
                                    "puresound_tpu_torch",
                                    "puresound_tpu_torch.*"]),
    # the port's CUDA sources, built with nvcc at first use on the card
    package_data={"puresound_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "scipy",
        "PyYAML",
    ],
    extras_require={
        "train": ["tensorboard", "matplotlib", "scikit-learn"],
        "test": ["pytest"],
        "torch": ["torch"],
        "metrics": ["pesq"],
    },
)
