"""The plain reference: float32 PyTorch with TF32 off (float64 where the
rLap sampler states it), no kernels, no code of the program. It imports
neither `jax` nor `rlap_tpu` nor `rlap_tpu_torch`; it takes the benchmark's
inputs and the program's outputs, which it only judges.

`precision="tf32"` computes it one step lower, as the control of the
comparison (see `PERF.md`): every matrix product in TF32, and the rLap
sampler in float32.
"""
