from .constant import ConstantField
from .loop import CurrentLoop
from .scaling import LinearRamp, Scale

__all__ = ["ConstantField", "CurrentLoop", "LinearRamp", "Scale"]
