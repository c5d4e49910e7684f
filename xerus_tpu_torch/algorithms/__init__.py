import torch

from ..config import require
from ..core.tensor import Tensor
from ..ops import mixed_precision as _mp
from ..tt.ttnetwork import TTTensor
from .performance_data import PerformanceData, NoPerfData, DataPoint
from .als import (ALSVariant, ALS, ALS_SPD, ALS_SPD_CG, DMRG, DMRG_SPD, ASD,
                  ASD_SPD)
from .measurements import SinglePointMeasurementSet, RankOneMeasurementSet
from .adf import ADFResult, ADFVariant, ADF, adf_cores
from .iht import IHT, iht_cores
from .largest_entry import find_largest_entry, find_largest_entry_cores
from .uq_adf import (UQMeasurementSet, uq_adf, uq_avg, uq_mc,
                     randvar_to_position)
from .retractions import (TTTangentVector, HOSVDRetractionI,
                          HOSVDRetractionII, ALSRetractionI, ALSRetractionII,
                          SubmanifoldRetractionI, SubmanifoldRetractionII,
                          ProjectiveVectorTransport, TTRetractionI,
                          TTRetractionII, TTVectorTransport)
from .steepest_descent import (SteepestDescentVariant, SteepestDescent,
                               line_search)
from .cg import GeometricCGVariant, GeometricCG
from .decomposition_als import decomposition_als
from .eigensolver import (EigenALSVariant, DMRG_groundstate, ALS_groundstate,
                          smallest_eigenvalue)
from .random_svd import randomTTSVD


def als_spd_mixed(A, x, b, num_half_sweeps: int = 6):
    """Mixed-precision (double-word f32) SPD ALS on TT objects
    (``ops/mixed_precision.als_spd_mixed``): float64-quality residuals
    from float32 arithmetic.  Returns the solution as a TTTensor."""
    return TTTensor._make([Tensor._wrap(c) for c in
                           _mp.als_spd_mixed(A, x, b, num_half_sweeps)])


def als_spd_fused(A, x, b, max_f32_sweeps: int = 16, df_sweeps: int = 2):
    """The whole mixed-precision SPD solve on TT objects
    (``ops/mixed_precision.als_f32_df_run``): float32 half-sweeps to the
    float32 plateau, then ``df_sweeps`` double-word half-sweeps, whose
    refinement residuals of the large local systems run kernel K1 on the
    card; each half-sweep is a replay of a captured program there
    (``ops/programs.py``) once its shape key has run eagerly twice.  Symmetric operators only (Cholesky local solves; ``ALS_SPD``
    picks LU for general ones).  ``x`` is not changed.  Returns (solution
    TTTensor, float32 residual history)."""
    require(A.is_symmetric(),
            "als_spd_fused requires a symmetric operator; "
            "use ALS_SPD for general operators")
    x = x.copy()
    x.move_core(0)
    f32 = [tuple(c._torch().to(torch.float32) for c in t.components)
           for t in (x, A, b)]
    A_df = tuple(_mp.df_split(c._torch()) for c in A.components)
    b_df = tuple(_mp.df_split(c._torch()) for c in b.components)
    out, hist, cnt = _mp.als_f32_df_run(*f32, A_df, b_df,
                                        int(max_f32_sweeps), int(df_sweeps))
    return (TTTensor._make([Tensor._wrap(_mp.df_join(h, l))
                            for (h, l) in out]),
            hist[:cnt].tolist())
