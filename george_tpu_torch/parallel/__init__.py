# -*- coding: utf-8 -*-
"""Multi-rank parallelism over ``torch.distributed``: meshes, chain
sharding, data sharding (:mod:`.dist_chol`: the distributed Cholesky)."""

from .mesh import chain_mesh, chain_data_mesh

__all__ = [
    "chain_mesh", "chain_data_mesh",
    "run_mcmc_sharded", "run_smc_sharded",
    "make_sharded_gp_log_prob_factory",
]

_SHARDED = ("run_mcmc_sharded", "run_smc_sharded",
            "make_sharded_gp_log_prob_factory")


def __getattr__(name):
    # Lazy: the samplers import this package's collectives, and .sharded
    # imports the samplers.
    if name in _SHARDED:
        from . import sharded

        return getattr(sharded, name)
    raise AttributeError(name)
