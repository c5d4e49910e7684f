"""xerus_tpu_torch: the PyTorch + CUDA port of xerus_tpu, for NVIDIA Hopper.

Imports torch and numpy, never jax.  The JAX package ``xerus_tpu`` stays
the reference that every ported function is tested against.  Ported so
far: the mixed-precision QTT Poisson ALS solve at core level
(``ops.mixed_precision.als_f32_df_run``) with its hand kernel K1, the
one-pass double-word matvec (``ops.df_matvec``, ``csrc/df_matvec.cu``);
deterministic and randomized TT rounding at core level
(``ops.round_kernels.tt_round_sweep_segmented``, ``_round_randomized``)
with its hand kernel K2, the certified GEMM-only truncation
(``ops.gemm_exact``, ``csrc/gemm_exact.cu``); tensor completion at core
level (``algorithms``) with its hand kernel K3 (``ops.tt_eval``,
``csrc/tt_eval.cu``); and the object layer below the tensor network:
``misc``, the dense + sparse ``Tensor`` with contraction, factorizations
and solves (``core``), the indexed-expression frontend (``indexing``), the
tensor network (``network``) and the TT classes with their arithmetic and
roundings (``tt``; ``TTTensor.round_fast(..., method="gemm_exact")`` runs
K2 on the card); and the algorithms on those objects (``algorithms``:
ALS / DMRG / ASD with ``ALS_SPD`` and ``als_spd_fused``, which runs K1;
ADF, IHT, the largest-entry search and UQ-ADF on ``TTTensor``s, whose
measurements run K3; ``PerformanceData``; the eigensolver
``smallest_eigenvalue`` and the two-site DMRG sweeps of
``ops.dmrg_kernels`` with ``dmrg_solve``; the Riemannian kit, steepest
descent and geometric CG; ``decomposition_als``, ``randomTTSVD``; the
fused apply + round ``ops.apply_operator_rounded``), with the problem
generators and the cascade example (``examples``) and ``models``, under
the JAX package's top-level names, ``warmup`` among them (it builds a
problem family's hand kernels and captures its programs before timed
work); the sparse QR of sparse Tensors (``core.sparse_qr``), the
rounding speed presets (``TTTensor.round_fast(speed=...)``) and the
parallel layer over
torch.distributed (``parallel``, with ``mesh=`` on ADF and UQ-ADF).
Object computations run on the card unless the caller enters ``host()``.
"""

from .config import (config, EPSILON, set_value_dtype, value_dtype, host,
                     cuda_device, require)

from .core import (Tensor, Representation, Initialisation, reshuffle,
                   approx_equal, approx_entrywise_equal,
                   contract, calculate_svd, calculate_qr, calculate_rq,
                   calculate_qc, calculate_cq, pseudo_inverse, solve,
                   solve_least_squares)
from .core import entrywise_product as _tensor_entrywise_product
from .indexing import Index, indices, SVD, QR, RQ, QC, CQ
from .indexing import Factorisation as TensorFactorisation
from .network import TensorNetwork, TensorNode
from .network import Link as TensorNetworkLink
from .tt import (TTNetwork, TTTensor, TTOperator, dyadic_product,
                 apply_operator)
from .tt import entrywise_product as _tt_entrywise_product


def entrywise_product(a, b):
    """Hadamard product for Tensors or TT networks (overloaded like the
    reference's xerus::entrywise_product)."""
    if isinstance(a, TTNetwork):
        return _tt_entrywise_product(a, b)
    return _tensor_entrywise_product(a, b)


from .misc import (FileFormat, save_to_file, load_from_file, LogHistogram,
                   set_seed, log, xethrow)
from .core import serialization as _serialization  # registers Tensor I/O

from .algorithms import (PerformanceData, NoPerfData, DataPoint, ALSVariant,
                         ALS, ALS_SPD, ALS_SPD_CG, DMRG, DMRG_SPD, ASD,
                         ASD_SPD, SinglePointMeasurementSet,
                         RankOneMeasurementSet, ADFVariant, ADF,
                         TTTangentVector, HOSVDRetractionI, HOSVDRetractionII,
                         ALSRetractionI, ALSRetractionII,
                         SubmanifoldRetractionI, SubmanifoldRetractionII,
                         ProjectiveVectorTransport, TTRetractionI,
                         TTRetractionII, TTVectorTransport,
                         SteepestDescentVariant, SteepestDescent,
                         GeometricCGVariant, GeometricCG, IHT,
                         decomposition_als, find_largest_entry,
                         UQMeasurementSet, uq_adf, uq_avg, uq_mc,
                         EigenALSVariant, DMRG_groundstate, ALS_groundstate,
                         smallest_eigenvalue, als_spd_mixed, als_spd_fused,
                         randomTTSVD)
from .ops.dmrg_kernels import dmrg_solve
from .warmup import warmup
from . import algorithms, convert, examples, models, ops


def frob_norm(x) -> float:
    return x.frob_norm()


def one_norm(x) -> float:
    return x.one_norm()
