from setuptools import setup, find_packages

setup(
    name="g3py_tpu",
    version="0.1.0",
    description="TPU-native generalized graphical Gaussian processes (JAX/XLA/Pallas)",
    packages=find_packages(exclude=("tests",)),
    package_data={"g3py_tpu.utils": ["datasets/*"],
                  "g3py_tpu_torch": ["csrc/*.cu"],
                  "g3py_tpu_torch.utils": ["datasets/*"]},
    include_package_data=True,
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy", "pandas"],
)
