"""The parallel layer over torch.distributed: the port of
``xerus_tpu/parallel`` (meshes, dp-sharded ADF / UQ-ADF / batched sweeps,
tp-sharded ALS and inner products, site-sharded TT arithmetic and the
rank-sharded TSQR rounding), SPMD over a ``DeviceMesh`` (``mesh.py``)."""

from . import mesh, sharded_ops, site_ops, tp_als, tsqr_round
from .mesh import default_mesh, measurement_sharding, replicated
from .sharded_ops import (sharded_adf_gradient, sharded_als_local_solve,
                          sharded_tt_inner, multichip_training_step)
from .tsqr_round import tt_round_tsqr
from .tp_als import tp_als_half_sweep, tp_als_solve
