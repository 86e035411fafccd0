"""Dtype policy.

* Coordinates and distances are float32: FPS, ball-query and kNN selections
  must be index-identical to the JAX reference, which bf16 coordinates
  cannot guarantee (near-ties would flip). A kNN handed bfloat16 clouds
  casts them to float32 at entry.
* Accumulation is float32: every kernel accumulates in float32, and every
  scatter-add backward (K4) sums in float32 and rounds once to the
  updates' dtype.
* Network *features* may be bfloat16: the layers' ``dtype=torch.bfloat16``
  runs their matmuls and norms in bfloat16 as flax's ``promote_dtype`` does
  (inputs, weights and biases rounded to bfloat16; a norm's statistics in
  float32), and the gathers of bfloat16 features run the gather kernel's
  bfloat16 instance, exactly.
* Parameters stay float32. The models promote their bfloat16 outputs back
  to float32 where they meet coordinates (the residual ``xyz + offsets``),
  so the loss kernels see float32.
"""

import torch

# Dtype used for coordinates / pairwise distances.
compute_dtype = torch.float32

# Dtype used for accumulation in matmuls and reductions.
accum_dtype = torch.float32
