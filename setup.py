from setuptools import setup, find_packages

setup(
    name="pysolvers_tpu",
    version="0.1.0",
    description=("TPU-native sparse linear-algebra and iterative-solver "
                 "framework (JAX/XLA/Pallas), with its PyTorch/CUDA port "
                 "pysolvers_tpu_torch"),
    packages=find_packages(include=["pysolvers_tpu", "pysolvers_tpu.*",
                                    "pysolvers_tpu_torch",
                                    "pysolvers_tpu_torch.*"]),
    package_data={"pysolvers_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
)
