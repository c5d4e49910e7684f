from .ttnetwork import (TTNetwork, TTTensor, TTOperator, inner,
                        entrywise_product, dyadic_product, apply_operator)
from . import serialization as _serialization  # registers TT I/O
from .stack import TTStack
