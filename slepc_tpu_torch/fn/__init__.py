from .fn import (
    FN,
    FNExp,
    FNLog,
    FNSqrt,
    FNInvSqrt,
    FNPhi,
    FNRational,
    FNCombine,
    fn_from_name,
)

__all__ = [
    "FN",
    "FNExp",
    "FNLog",
    "FNSqrt",
    "FNInvSqrt",
    "FNPhi",
    "FNRational",
    "FNCombine",
    "fn_from_name",
]
