from .cheb import ChebAmplifyOperator, cheb_value, gershgorin_upper
from .st import STShift

__all__ = ["STShift", "ChebAmplifyOperator", "cheb_value", "gershgorin_upper"]
