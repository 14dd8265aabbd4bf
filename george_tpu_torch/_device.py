# -*- coding: utf-8 -*-
"""Device resolution shared by the package's entry points.

Every entry point (``GP``, ``build_gp_log_prob``, ``run_mcmc``, kernel
evaluation) runs on the CUDA card unless the caller asks for another device.
Without a card and without an explicit ``device="cpu"`` it raises: nothing
carries on quietly on the CPU.
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``None`` -> the current CUDA device (or raise); else ``torch.device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "george_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device {0} requested but CUDA is not "
                           "available".format(device))
    return device
