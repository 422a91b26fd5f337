from .rg import RG, RGEllipse, RGInterval, RGPolygon, RGRing

__all__ = ["RG", "RGEllipse", "RGInterval", "RGPolygon", "RGRing"]
