from .cheb import ChebAmplifyOperator, cheb_value, gershgorin_upper
from .st import ST, STShift, STSinvert, STCayley, STPrecond, STShell
from .sinvert_jit import SinvertCGOperator, STSinvertDevice
from .filter import STFilter, estimate_spectral_bounds

__all__ = ["ST", "STShift", "STSinvert", "STCayley", "STPrecond", "STShell",
           "SinvertCGOperator", "STSinvertDevice", "ChebAmplifyOperator",
           "cheb_value", "gershgorin_upper", "STFilter",
           "estimate_spectral_bounds"]
