from .tensor import (Tensor, Representation, Initialisation, reshuffle,
                     entrywise_product, approx_equal, approx_entrywise_equal)
from .contract import contract
from .factorizations import (calculate_svd, calculate_qr, calculate_rq,
                             calculate_qc, calculate_cq, pseudo_inverse,
                             solve, solve_least_squares)
