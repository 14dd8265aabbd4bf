# -*- coding: utf-8 -*-
"""Global knobs of the port (the JAX package's ``config.py``, the subset
the ported routes read, with the same names and defaults)."""

__all__ = ["pallas_covariance", "pallas_min_elements", "pallas_dense",
           "dense_mxu_min_n", "dense_mxu_sampling", "engine_log"]

# When a stationary covariance build takes the hand-written tiled kernel
# (``ops/cov.py``: ``csrc/stationary_cov.cu`` for tensors on the card):
#   "auto"   — on the card, float32, unblocked stationary leaves, and the
#              output has at least ``pallas_min_elements`` entries;
#   "always" — on the card, every unblocked stationary leaf, any size and
#              float32 or float64;
#   "never"  — the plain PyTorch build only.
# On the CPU the plain build always runs.  Read at every build.
pallas_covariance = "auto"
pallas_min_elements = 1 << 20

# The fused batched dense value+gradient engine for posteriors without a
# state-space form (``ops/dense.py``: the CUDA kernel for tensors on the
# card, its plain PyTorch version for tensors on the CPU):
#   "auto"  — attach it where it applies (N <= 256, metric types 0/1);
#   "never" — the plain dense density with autograd gradients only.
# (The JAX package's "always" ran its Pallas kernel in interpret mode on a
# CPU; the CPU here always takes the plain version.)
pallas_dense = "auto"

# N at and above which the dense router prefers the blocked engine
# (``ops/dense_mxu.py``, the JAX package's MXU hybrid: batched matrix
# products around the CUDA spine kernel ``csrc/dense_spine.cu``, N <= 512,
# every metric type) over the fused engine, when ``dense_mxu_sampling``
# opts in.
dense_mxu_min_n = 129

# Whether the sampler router may pick the blocked engine at all (opt-in in
# the JAX package after its posterior-fidelity finding on the TPU).
dense_mxu_sampling = False

# Emit a one-line warning (logging.getLogger("george_tpu_torch")) when a
# posterior falls out of a fused engine's envelope onto the plain route.
engine_log = True
