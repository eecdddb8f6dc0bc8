from .units import DimensionalityError, Quantity, UnitRegistry, ureg

__all__ = ["DimensionalityError", "Quantity", "UnitRegistry", "ureg"]
