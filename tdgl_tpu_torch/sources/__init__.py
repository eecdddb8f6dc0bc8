from .constant import ConstantField
