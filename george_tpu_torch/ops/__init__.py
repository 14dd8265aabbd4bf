# -*- coding: utf-8 -*-
"""Numerical operators: the state-space filter and the fused Kalman
value+gradient (CUDA kernel and its plain PyTorch version)."""
