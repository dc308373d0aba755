"""Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, without
sparsity), at its full 700 W power limit; a card set lower runs slower under
load, so every run prints its card's ``power.limit`` beside them.

* ``f32``: 67 TFLOP/s on the CUDA cores counts a fused multiply-add as two
  operations; the SNN's gated adds, multiplies and compares are one f32
  instruction each, so their peak is half that: 33.5e12 a second.
* ``bf16_tensor``: 989e12 FLOP/s on the tensor cores, a multiply-add two.
* ``bytes``: 3.35e12 bytes a second of HBM3.
"""
PEAKS = {"f32": 67e12 / 2, "bf16_tensor": 989e12}
PEAK_BYTES = 3.35e12
POWER_W = 700.0
