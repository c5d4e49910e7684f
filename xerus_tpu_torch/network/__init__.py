from .network import TensorNetwork, TensorNode, Link
from . import dsl as _dsl  # installs TensorNetwork.assign_indexed
from . import serialization as _serialization  # registers TensorNetwork I/O
from .heuristics import best_contraction_order
