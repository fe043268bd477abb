# -*- coding: utf-8 -*-
"""Multi-rank parallel execution (the mesh / sharding layer).

Counterpart of `ssqueezepy_tpu/parallel/`, on `torch.distributed`: one
process per rank (each on its own card, or the CPU), a `DeviceMesh` whose
dimensions are named as the JAX mesh's axes ('batch', 'scale', 'time'),
and explicit collectives on each dimension's process group
(`collectives.py`). The CWT filterbank rows (scales), the STFT's rows, the
signals (batch) and the time axis shard across ranks; each rank runs the
ported kernels on its block, the synchrosqueezing bin reduction is a sum
over 'scale', and `icwt`'s scale sum likewise. Importing starts no
process group: the first mesh (or `init_distributed`) does.
"""
from .mesh import make_mesh, mesh_info
from .sharded import (sharded_ssq_cwt, sharded_cwt, ShardedSSQCWT,
                      dryrun_multichip)
from .time_sharded import (TimeShardedSSQCWT, time_sharded_cwt,
                           time_sharded_ssq_cwt, make_mesh_time)
from .full_sharded import FullShardedSSQCWT, make_mesh3
from .distributed import init_distributed, make_host_chip_mesh
from .inverse import sharded_icwt, sharded_issq_cwt
from .sharded_stft import (ShardedSSQSTFT, ShardedSSQSTFT2,
                           sharded_ssq_stft)
from .sharded_order2 import ShardedSSQCWT2
from .health import collective_heartbeat, HealthMonitor

__all__ = ['make_mesh', 'mesh_info', 'sharded_ssq_cwt', 'sharded_cwt',
           'ShardedSSQCWT', 'dryrun_multichip', 'TimeShardedSSQCWT',
           'time_sharded_cwt', 'time_sharded_ssq_cwt', 'make_mesh_time',
           'init_distributed', 'make_host_chip_mesh', 'FullShardedSSQCWT',
           'make_mesh3', 'sharded_icwt', 'sharded_issq_cwt',
           'ShardedSSQSTFT', 'ShardedSSQSTFT2', 'sharded_ssq_stft',
           'ShardedSSQCWT2', 'collective_heartbeat', 'HealthMonitor']
