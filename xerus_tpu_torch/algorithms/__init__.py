from . import adf, iht, largest_entry, measurements
from .adf import ADFResult, ADFVariant
from .iht import IHT
from .largest_entry import find_largest_entry
from .measurements import RankOneMeasurementSet, SinglePointMeasurementSet
