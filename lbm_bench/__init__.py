"""The benchmark of latticeboltzmann_tpu_torch on an NVIDIA card: see
README.md beside this file and BENCHMARK.json at the repository root."""
