"""Dtype policy.

Coordinates and distances are float32: FPS, ball-query and kNN selections
must be index-identical to the JAX reference, which bf16 coordinates cannot
guarantee (near-ties would flip). Network features may use a lower
precision in later work; accumulation stays float32.
"""

import torch

# Dtype used for coordinates / pairwise distances.
compute_dtype = torch.float32

# Dtype used for accumulation in matmuls and reductions.
accum_dtype = torch.float32
