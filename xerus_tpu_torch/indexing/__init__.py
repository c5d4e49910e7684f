from .index import Index, indices
from .expressions import (IndexedTensor, Expression, Product, Sum, SolveExpr,
                          Factorisation, SVD, QR, RQ, QC, CQ)
